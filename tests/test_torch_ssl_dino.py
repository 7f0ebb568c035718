"""Port parity for DINO (wespeaker_tpu_torch/ssl/dino.py) against the JAX
package's wespeaker_tpu/ssl/dino.py, in f32 on the CPU, from the same
numpy-seeded inputs and weights carried across by
utils.weights.from_jax_variables / from_jax_dino_state.

  - DINOHead with and without BatchNorm, in train and in eval mode: the
    output and the updated running statistics within 1e-5 of the largest
    magnitude;
  - cosine_scheduler and teacher_temp_schedule over a grid of steps:
    within 1e-6 of the schedule's largest value (the JAX functions run in
    f32, the port's in Python floats);
  - dino_loss in modes 0, 1 and 2, param_wise_clip, and
    make_dino_optimizer's SGD, AdamW and LARS (the port's LARS is its own
    torch.optim.Optimizer) against optax over 3 updates with the decay
    mask: 1e-6 (optax in f64, see test_dino_optimizers_match_optax);
  - three DINO steps of a narrow ECAPA (C=32, feat 24, embed 32, global
    context) with a BN head 64/64/16, B=4 with 2 global crops of 50
    frames and 2 local crops of 20, SGD with momentum, the last layer
    frozen for the first step and a clip that acts on most tensors. The
    port's fused=True (on the CPU the training tail's autograd Function
    with its plain forward and backward, the eval kernels' plain versions
    for the teacher) is paired with JAX's fused_tail=True in interpret
    mode. Loss, center, the student's BN statistics and the teacher's
    parameters agree within 1e-4 of each tensor's largest magnitude (a
    running mean within 1e-4 of its feature's scale, the larger of its
    largest magnitude and the largest running std: the head's first BN
    sees the embedding, whose batch mean is zero in exact arithmetic, the
    ECAPA embedding BN's zero-mean output through a zero-init bias, so its
    running mean is rounding noise near 1e-8 on both sides), the
    momentum buffers within 3e-3 of their norm (the bar of
    test_torch_train.py::test_two_train_steps_match_jax, whose docstring
    says why);
  - the state mapping, loaded strictly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu.ssl import dino as JD  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.ssl import dino as D  # noqa: E402
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_dino_state, from_jax_variables)

torch.set_num_threads(2)
CPU = torch.device("cpu")
# biases whose exact gradient is 0, so that what they get is rounding
# noise: b2 shifts a whole softmax column over frames; the pooled BN's
# bias, the embedding's bias and the head's hidden biases each shift a
# feature by a constant that the next BatchNorm over the batch removes
# (the head's BNs in train mode)
ZERO_GRAD = ("backbone.pool.linear2.bias", "backbone.bn.bias",
             "backbone.linear.bias", "head.mlp_0.bias", "head.mlp_1.bias")


def _rel_close(got, want, tol, what, scale=None):
    """max |got - want| within tol of max |want| (or of `scale`)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scale is None:
        scale = float(np.max(np.abs(want)))
    scale = max(scale, 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"


def _norm_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-12)
    assert err <= tol, f"{what}: error {err:.3g} of its norm > {tol}"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_head(use_bn, rng):
    """A JAX DINOHead (in 32, hidden 48, bottleneck 16, out 64), its
    variables with random BN statistics, and the port's head loaded from
    them."""
    jh = JD.DINOHead(out_dim=64, use_bn=use_bn, hidden_dim=48,
                     bottleneck_dim=16)
    variables = _np_tree(jh.init(jax.random.PRNGKey(1),
                                 jnp.zeros((2, 32))))
    if use_bn:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            variables["batch_stats"])
    head = D.DINOHead(32, 64, use_bn=use_bn, hidden_dim=48,
                      bottleneck_dim=16)
    head.load_state_dict(from_jax_variables(variables, "DINOHead"),
                         strict=True)
    return jh, variables, head


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_head_matches_jax(use_bn, train):
    rng = np.random.default_rng(0)
    jh, variables, head = _jax_head(use_bn, rng)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    head.train(train)
    got = head(torch.from_numpy(x))
    if train and use_bn:
        want, mut = jh.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        stats = from_jax_variables({"batch_stats": mut["batch_stats"]})
        sd = head.state_dict()
        for key, value in stats.items():
            if key.endswith(("running_mean", "running_var")):
                _rel_close(sd[key], value, 1e-5, key)
    else:
        want = jh.apply(variables, jnp.asarray(x), train=train)
    assert got.shape == (6, 64)
    _rel_close(got.detach(), want, 1e-5, "head output")


def test_head_layouts_and_frozen_g():
    head = D.DINOHead(32, 64, use_bn=True, hidden_dim=48, bottleneck_dim=16)
    assert head.last_layer_v.shape == (16, 64)
    assert not head.last_layer_g.requires_grad
    assert D.DINOHead(32, 64, norm_last_layer=False).last_layer_g \
        .requires_grad
    one = D.DINOHead(32, 64, nlayers=1, bottleneck_dim=16)
    assert [n for n, _ in one.named_children()] == ["mlp_0"]
    assert one(torch.randn(3, 32)).shape == (3, 64)


@pytest.mark.parametrize("args", [(0.2, 5e-5, 10, 7, 2),
                                  (0.996, 1.0, 150, 3, 0),
                                  (1.0, 0.1, 10, 10, 2, 0.05)])
def test_cosine_scheduler_matches_jax(args):
    jfn, fn = JD.cosine_scheduler(*args), D.cosine_scheduler(*args)
    top = max(abs(args[0]), abs(args[1]))
    total = args[2] * args[3]
    for step in list(range(0, total + 3)) + [total // 2, 10 * total]:
        assert abs(fn(step) - float(jfn(step))) <= 1e-6 * top, step
        assert isinstance(fn(step), float)


@pytest.mark.parametrize("args", [(0.04, 0.07, 150, 11),
                                  (0.04, 0.07, 10, 5, 0.5),
                                  (0.04, 0.07, 2, 5)])
def test_teacher_temp_schedule_matches_jax(args):
    jfn, fn = JD.teacher_temp_schedule(*args), D.teacher_temp_schedule(*args)
    for step in range(0, args[2] * args[3] + 5, max(args[3] // 2, 1)):
        assert abs(fn(step) - float(jfn(step))) <= 1e-6 * 0.07, step


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dino_loss_matches_jax(mode):
    rng = np.random.default_rng(mode)
    b, k, ns, nt = 3, 40, 6, 2
    s = rng.standard_normal((ns * b, k)).astype(np.float32)
    t = rng.standard_normal((nt * b, k)).astype(np.float32)
    center = rng.standard_normal((1, k)).astype(np.float32) * 0.1
    want = JD.dino_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(center),
                        0.04, ns, nt, 0.1, mode)
    got = D.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                      torch.from_numpy(center), 0.04, ns, nt, 0.1, mode)
    _rel_close(float(got), float(want), 1e-6, f"mode {mode} loss")
    with pytest.raises(ValueError, match="views"):
        D.dino_loss(torch.from_numpy(s[:-1]), torch.from_numpy(t),
                    torch.from_numpy(center), 0.04, ns, nt)


def test_param_wise_clip_matches_jax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(shape).astype(np.float32) * scale
             for shape, scale in (((4, 5), 1.0), ((7,), 0.01), ((3, 2, 2),
                                                                10.0))]
    want = JD.param_wise_clip([jnp.asarray(g) for g in grads], None, 0.5)
    got = D.param_wise_clip([torch.from_numpy(g.copy()) for g in grads],
                            0.5)
    for i, (gv, wv) in enumerate(zip(got, want)):
        _rel_close(gv, wv, 1e-6, f"grad {i}")
    # the small one is left as it is
    np.testing.assert_array_equal(got[1].numpy(), grads[1])


@pytest.mark.parametrize("kind", ["sgd", "adamw", "lars"])
def test_dino_optimizers_match_optax(kind):
    """Three updates of the head's parameters with the decay mask (biases
    and 1-D parameters undecayed; g frozen, its JAX gradient zero). optax
    runs in f64 on the f32 values: in f32 it computes Adam's 1 - 0.999^t
    1.3e-5 off at t = 1 and moves every Adam step by ~6.5e-6 of its size,
    where torch computes that factor in double."""
    rng = np.random.default_rng(4)
    _, variables, head = _jax_head(True, rng)
    params = variables["params"]
    opt = D.make_dino_optimizer(kind, head, weight_decay=0.05)
    mask = D.no_weight_decay_mask(head)
    assert not mask["mlp_0.bias"] and not mask["mlp_bn_0.weight"]
    assert mask["mlp_0.weight"] and mask["last_layer_v"]
    lr = 0.1 if kind == "lars" else 0.01
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                        params)
        tx = JD.make_dino_optimizer(kind, params, weight_decay=0.05)
        opt_state = tx.init(params)
        for _ in range(3):
            grads = jax.tree_util.tree_map(
                lambda a: rng.standard_normal(a.shape).astype(np.float32),
                params)
            grads["last_layer_g"] = np.zeros_like(grads["last_layer_g"])
            opt_state.hyperparams["learning_rate"] = lr
            updates, opt_state = tx.update(jax.tree_util.tree_map(
                lambda a: a.astype(np.float64), grads), opt_state, params)
            params = _np_tree(optax.apply_updates(params, updates))
            tgrads = from_jax_variables({"params": grads}, "DINOHead")
            for group in opt.param_groups:
                group["lr"] = lr
            for name, p in head.named_parameters():
                p.grad = tgrads[name].clone() if p.requires_grad else None
            opt.step()
    want = from_jax_variables({"params": params}, "DINOHead")
    for name, p in head.named_parameters():
        _rel_close(p.detach(), want[name], 1e-6, f"{kind} {name}")


def _trace(opt_state):
    """The momentum tree inside optax's inject_hyperparams(sgd)."""
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


FEAT, EMB, C, B, NG, NL = 24, 32, 32, 4, 2, 2


def _jax_dino(freeze, clip):
    """JAX's backbone with the fused tail, its head, SGD, a state and the
    config. The state is initialised, in one jitted call, through the
    unfused twin, whose parameter tree is the same, so that init does not
    trace the tail's interpret-mode kernel."""
    ecapa = dict(channels=C, feat_dim=FEAT, embed_dim=EMB,
                 global_context_att=True, fused_block=False)
    jb = JECAPA(**ecapa, fused_tail=True)
    jh = JD.DINOHead(out_dim=64, hidden_dim=64, bottleneck_dim=16,
                     use_bn=True)
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0,
                                             momentum=0.9)
    state = jax.jit(lambda key: JD.init_dino_state(
        JECAPA(**ecapa, fused_tail=False), jh, tx, key, feat_dim=FEAT,
        embed_dim=EMB))(jax.random.PRNGKey(0))
    cfg = JD.DINOConfig(out_dim=64, n_global=NG, n_local=NL,
                        freeze_last_layer_iters=freeze, clip_grad=clip)
    return jb, jh, tx, state, cfg


def _port_dino(host_state):
    """The port's state from the JAX one, loaded strictly."""
    backbone = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True, fused=True)
    head = D.DINOHead(EMB, 64, use_bn=True, hidden_dim=64, bottleneck_dim=16)
    state = D.init_dino_state(backbone, head, lambda m: torch.optim.SGD(
        [p for p in m.parameters() if p.requires_grad], lr=0.0,
        momentum=0.9), CPU)
    mapped = from_jax_dino_state(host_state)
    state.student.load_state_dict(mapped["student"], strict=True)
    state.teacher.load_state_dict(mapped["teacher"], strict=True)
    return state._replace(center=mapped["center"])


def test_dino_state_mapping_loads_strictly():
    *_, state, _ = _jax_dino(0, 3.0)
    host = _np_tree(fser.to_state_dict(state))
    mapped = from_jax_dino_state(host)
    assert mapped["step"] == 0 and mapped["center"].shape == (1, 64)
    port = _port_dino(host)
    sd = port.student.state_dict()
    assert set(sd) == set(mapped["student"]) == set(mapped["teacher"])
    np.testing.assert_array_equal(
        sd["head.last_layer_v"].numpy(),
        host["student"]["head"]["last_layer_v"])
    np.testing.assert_array_equal(
        sd["head.mlp_0.weight"].numpy(),
        host["student"]["head"]["mlp_0"]["kernel"].T)
    assert "backbone.layer2.se_res2block.1.convs.0.weight" in sd
    assert all(not p.requires_grad for p in port.teacher.parameters())
    broken = dict(mapped["student"])
    broken.pop("head.last_layer_g")
    with pytest.raises(RuntimeError, match="last_layer_g"):
        port.student.load_state_dict(broken, strict=True)


def test_three_dino_steps_match_jax():
    clip = 0.05
    jb, jh, tx, state, cfg = _jax_dino(freeze=1, clip=clip)
    sched = dict(lr=(0.05, 0.01, 3, 1, 1), mom=(0.9, 1.0, 3, 1),
                 temp=(0.04, 0.07, 5, 1))
    jstep = jax.jit(JD.make_dino_train_step(
        JD.make_apply_fn(jb, jh), tx, JD.cosine_scheduler(*sched["lr"]),
        JD.cosine_scheduler(*sched["mom"]),
        JD.teacher_temp_schedule(*sched["temp"]), cfg))
    port = _port_dino(_np_tree(fser.to_state_dict(state)))
    teacher0 = {k: v.clone() for k, v in port.teacher.state_dict().items()}
    step = D.DINOTrainStep(
        port, D.cosine_scheduler(*sched["lr"]),
        D.cosine_scheduler(*sched["mom"]),
        D.teacher_temp_schedule(*sched["temp"]),
        D.DINOConfig(out_dim=64, n_global=NG, n_local=NL,
                     freeze_last_layer_iters=1, clip_grad=clip))
    rng = np.random.default_rng(5)
    clipped = 0
    for i in range(3):
        batch = {"global_feat": rng.standard_normal(
                     (NG * B, 50, FEAT)).astype(np.float32),
                 "local_feat": rng.standard_normal(
                     (NL * B, 20, FEAT)).astype(np.float32)}
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = step(batch)
        for key in ("loss", "lr", "momentum", "teacher_temp"):
            _rel_close(float(tm[key]), float(jm[key]), 1e-4,
                       f"step {i} {key}")
        grads = {n: p.grad for n, p in port.student.named_parameters()
                 if p.grad is not None}
        frozen = [n for n in grads if "last_layer" in n]
        assert frozen == ["head.last_layer_v"]
        assert (grads["head.last_layer_v"].abs().max().item() == 0) == (
            i == 0)
        # the clip acted: those tensors come out at norm `clip`
        clipped += sum(abs(g.norm().item() - clip) < 1e-5 * clip
                       for g in grads.values())
    assert step.step == 3 and int(state.step) == 3
    assert clipped > 30, clipped

    host = _np_tree(fser.to_state_dict(state))
    want = from_jax_dino_state(host)
    _rel_close(step.center, want["center"], 1e-4, "center")
    got_s, got_t = port.student.state_dict(), port.teacher.state_dict()
    for key, value in want["student"].items():
        if key.endswith(("running_mean", "running_var")):
            # a mean on the scale of its feature: the larger of the largest
            # |mean| and the largest std (module docstring)
            var = want["student"][key.replace("_mean", "_var")]
            scale = max(float(value.abs().max()),
                        float(var.sqrt().max()))
            _rel_close(got_s[key], value, 1e-4, f"student {key}", scale)
            # the teacher's statistics are the student's, copied
            torch.testing.assert_close(got_t[key], got_s[key], rtol=0,
                                       atol=0)
    for key, value in want["teacher"].items():
        if key.endswith("num_batches_tracked"):
            assert int(got_s[key]) == 6, key  # two forwards a step
        elif key in ZERO_GRAD:
            assert (got_t[key] - teacher0[key]).abs().max() < 1e-6, key
        elif not key.endswith(("running_mean", "running_var")):
            _rel_close(got_t[key], value, 1e-4, f"teacher {key}")
            if key != "head.last_layer_g":
                assert not torch.equal(got_t[key], teacher0[key]), key
    trace = from_jax_dino_state({
        "student": _trace(state.opt_state), "teacher": _trace(
            state.opt_state), "student_stats": {}, "teacher_stats": {},
        "center": host["center"]})["student"]
    for name, p in port.student.named_parameters():
        if not p.requires_grad:
            assert np.abs(trace[name].numpy()).max() == 0, name
            continue
        buf = port.optimizer.state[p]["momentum_buffer"]
        if name in ZERO_GRAD:
            assert buf.abs().max().item() < 1e-5, name
            continue
        _norm_close(buf, trace[name], 3e-3, f"momentum {name}")
