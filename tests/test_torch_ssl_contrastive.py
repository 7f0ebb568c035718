"""Port parity for MoCo and SimCLR (wespeaker_tpu_torch/ssl/contrastive.py)
against the JAX package's wespeaker_tpu/ssl/contrastive.py, in f32 on the
CPU, from the same numpy-seeded inputs and weights carried across by
utils.weights.from_jax_variables.

  - moco_loss (loss, accuracy, the normalised keys), enqueue (with the
    pointer wrapping) and simclr_loss with 2 and 3 views: 1e-6;
  - three MoCo steps of a narrow ECAPA (C=32, feat 24, embed 32, global
    context, B=4 x 40 frames) with the queue (K=12, so the pointer wraps)
    taken from JAX's state, and two SimCLR steps (2 views of B=4): the
    DINO steps' bars (tests/test_torch_ssl_dino.py), losses, the queue,
    the key encoder's parameters and the BN statistics within 1e-4 of
    each tensor's largest magnitude (a running mean of its feature's
    scale), momentum buffers within 3e-3 of their norm, b2's (a softmax
    shift, exact gradient 0) below 1e-5. The key encoder's move over the
    three steps, the EMA of the query's updates, is held at the updates'
    3e-3 of its norm; flax starts the biases at zero, so a bias of the key
    encoder is that move alone, and its value is held at 1e-4 only where
    it does not start at zero. The port's fused=True is paired with JAX's
    fused_tail=True in interpret mode. The LR is small for the reason
    test_torch_train.py gives (see LR below);
  - twenty MoCo steps, each from the JAX state before it (loss and queue
    within 1e-4), and a free run whose drift from JAX stays within 3x the
    JAX package's own two paths' drift (the test's docstring).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.test_torch_ssl_dino import (_norm_close, _rel_close,  # noqa
                                       _trace)
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu.ssl import contrastive as JC  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.ssl import contrastive as C  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
FEAT, EMB, CH, B, T = 24, 32, 32, 4, 40
B2 = "pool.linear2.bias"  # a softmax shift: its exact gradient is 0


def test_moco_loss_and_enqueue_match_jax():
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((5, 8)).astype(np.float32) for _ in range(2))
    queue = np.array(JC.l2norm(jnp.asarray(
        rng.standard_normal((10, 8)).astype(np.float32))))
    jl, ja, jk = JC.moco_loss(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(queue), 0.07)
    tl, ta, tk = C.moco_loss(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(queue), 0.07)
    _rel_close(float(tl), float(jl), 1e-6, "moco loss")
    assert float(ta) == float(ja)
    _rel_close(tk, jk, 1e-6, "keys")
    assert not tk.requires_grad
    # the pointer wraps at K: 10 = 2 x 5
    jq, jp = jnp.asarray(queue), 0
    tq, tp = torch.from_numpy(queue.copy()), 0
    for i in range(3):
        keys = rng.standard_normal((5, 8)).astype(np.float32)
        jq, jp = JC.enqueue(jq, jp, jnp.asarray(keys))
        tq, tp = C.enqueue(tq, tp, torch.from_numpy(keys))
        assert tp == int(jp) == (5 * (i + 1)) % 10
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    with pytest.raises(ValueError, match="overrun"):
        C.enqueue(tq, 8, torch.zeros(5, 8))


@pytest.mark.parametrize("n_views", [2, 3])
def test_simclr_loss_matches_jax(n_views):
    f = np.random.default_rng(n_views).standard_normal(
        (n_views * 5, 8)).astype(np.float32)
    want = JC.simclr_loss(jnp.asarray(f), n_views, 0.07)
    got = C.simclr_loss(torch.from_numpy(f), n_views, 0.07)
    _rel_close(float(got), float(want), 1e-6, f"simclr {n_views} views")


def _encoders():
    """JAX ECAPA and its variables (from the unfused twin's init: the same
    tree, without tracing the tail's interpret-mode kernel); the port's,
    loaded from them."""
    ecapa = dict(channels=CH, feat_dim=FEAT, embed_dim=EMB,
                 global_context_att=True, fused_block=False)
    jb = JECAPA(**ecapa, fused_tail=True)
    variables = jax.tree_util.tree_map(np.asarray, JECAPA(
        **ecapa, fused_tail=False).init(jax.random.PRNGKey(0),
                                        jnp.zeros((2, 20, FEAT))))
    model = ECAPA_TDNN(CH, FEAT, EMB, global_context_att=True, fused=True)
    model.load_state_dict(from_jax_variables(variables), strict=True)

    def encode_fn(params, stats, feats, train):
        v = {"params": params, "batch_stats": stats}
        if train:
            emb, mut = jb.apply(v, feats, train=True,
                                mutable=["batch_stats"])
            return emb, mut["batch_stats"]
        return jb.apply(v, feats, train=False), stats

    return variables, model, encode_fn


def _check_stats(got, params, stats, what):
    want = from_jax_variables({"params": params, "batch_stats": stats})
    for key, value in want.items():
        if key.endswith("running_mean"):
            var = want[key.replace("_mean", "_var")]
            _rel_close(got[key], value, 1e-4, f"{what} {key}",
                       max(float(value.abs().max()),
                           float(var.sqrt().max())))
        elif key.endswith("running_var"):
            _rel_close(got[key], value, 1e-4, f"{what} {key}")


def _check_momentum(model, opt, opt_state):
    trace = from_jax_variables({"params": _trace(opt_state)})
    for name, p in model.named_parameters():
        buf = opt.state[p]["momentum_buffer"]
        if name == B2:
            assert buf.abs().max().item() < 1e-5, name
            continue
        _norm_close(buf, trace[name], 3e-3, f"momentum {name}")


# the LR schedule's (base, final, epochs, iters): at base 0.05 the third
# MoCo step's loss differs by 1.3e-3 between the JAX package's own two
# paths (fused_tail True and False, the same math; measured on this
# configuration), as it does between JAX and the port; at 0.005 by 1.3e-5
LR = (0.005, 0.001, 3, 1)


def test_three_moco_steps_match_jax():
    variables, model, encode_fn = _encoders()
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0,
                                             momentum=0.9)
    K, m = 12, 0.9
    state = JC.MoCoState(
        step=jnp.zeros((), jnp.int32), query_params=variables["params"],
        key_params=variables["params"],
        batch_stats=variables["batch_stats"],
        key_stats=variables["batch_stats"],
        queue=JC.l2norm(jax.random.normal(jax.random.PRNGKey(1),
                                          (K, EMB))),
        queue_ptr=jnp.zeros((), jnp.int32),
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))
    from wespeaker_tpu.ssl.dino import cosine_scheduler as jcos

    from wespeaker_tpu_torch.ssl.dino import cosine_scheduler
    jstep = jax.jit(JC.make_moco_train_step(encode_fn, tx, jcos(*LR), m=m))
    opt = torch.optim.SGD(model.parameters(), lr=0.0, momentum=0.9)
    step = C.MoCoTrainStep(model, opt, cosine_scheduler(*LR),
                           torch.from_numpy(np.array(state.queue)), m=m)
    key0 = {k: v.clone() for k, v in step.key_encoder.state_dict().items()}
    rng = np.random.default_rng(6)
    for i in range(3):
        batch = {k: rng.standard_normal((B, T, FEAT)).astype(np.float32)
                 for k in ("q_feat", "k_feat")}
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = step(batch)
        _rel_close(float(tm["loss"]), float(jm["loss"]), 1e-4,
                   f"step {i} loss")
        assert float(tm["acc"]) == float(jm["acc"]), i
        assert step.queue_ptr == int(state.queue_ptr) == (B * (i + 1)) % K
    _rel_close(step.queue, state.queue, 1e-4, "queue")
    _check_stats(model.state_dict(), state.query_params, state.batch_stats,
                 "query")
    key_sd = step.key_encoder.state_dict()
    for name, buf in model.named_buffers():
        assert torch.equal(key_sd[name], buf), name  # copied, not averaged
    want = from_jax_variables({"params": state.key_params})
    for name, value in want.items():
        moved = key_sd[name] - key0[name]
        if name == B2:
            assert moved.abs().max() < 1e-6
            continue
        # the EMA of the query's updates, at the updates' bar; the value
        # at 1e-4 where it does not start at zero (flax's zero biases are
        # their updates alone)
        _norm_close(moved, value - key0[name], 3e-3, f"key {name} moved")
        if key0[name].abs().max() > 0:
            _rel_close(key_sd[name], value, 1e-4, f"key {name}")
    _check_momentum(model, opt, state.opt_state)


def test_two_simclr_steps_match_jax():
    variables, model, encode_fn = _encoders()
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0,
                                             momentum=0.9)
    state = JC.SimCLRState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))
    from wespeaker_tpu.ssl.dino import cosine_scheduler as jcos

    from wespeaker_tpu_torch.ssl.dino import cosine_scheduler
    jstep = jax.jit(JC.make_simclr_train_step(encode_fn, tx, jcos(*LR)))
    opt = torch.optim.SGD(model.parameters(), lr=0.0, momentum=0.9)
    step = C.SimCLRTrainStep(model, opt, cosine_scheduler(*LR))
    rng = np.random.default_rng(7)
    for i in range(2):
        feat = rng.standard_normal((2 * B, T, FEAT)).astype(np.float32)
        state, jm = jstep(state, {"feat": jnp.asarray(feat)})
        tm = step({"feat": feat})
        _rel_close(float(tm["loss"]), float(jm["loss"]), 1e-4,
                   f"step {i} loss")
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert step.step == 2
    _check_stats(model.state_dict(), state.params, state.batch_stats,
                 "encoder")
    want = from_jax_variables({"params": state.params})
    for name, p in model.named_parameters():
        if name != B2:
            _norm_close(p.detach(), want[name], 2e-3, name)
    _check_momentum(model, opt, state.opt_state)


# twenty steps on one cosine schedule: the per-step comparison of the
# open fault "the SSL smokes trail the JAX package's runs" (ROADMAP.md
# Queue 3)
LR20 = (0.005, 0.001, 20, 1)


def _moco_state(variables, tx, K):
    return JC.MoCoState(
        step=jnp.zeros((), jnp.int32), query_params=variables["params"],
        key_params=variables["params"],
        batch_stats=variables["batch_stats"],
        key_stats=variables["batch_stats"],
        queue=JC.l2norm(jax.random.normal(jax.random.PRNGKey(1),
                                          (K, EMB))),
        queue_ptr=jnp.zeros((), jnp.int32),
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(2))


def _sync_moco(step, opt, state):
    """The port's step set to the JAX state: both encoders, the queue and
    its pointer, the momentum buffers and the step count."""
    step.encoder.load_state_dict(from_jax_variables(
        {"params": state.query_params, "batch_stats": state.batch_stats}))
    step.key_encoder.load_state_dict(from_jax_variables(
        {"params": state.key_params, "batch_stats": state.key_stats}))
    step.queue = torch.from_numpy(np.array(state.queue))
    step.queue_ptr = int(state.queue_ptr)
    step.step = int(state.step)
    trace = from_jax_variables({"params": _trace(state.opt_state)})
    for name, p in step.encoder.named_parameters():
        opt.state[p]["momentum_buffer"] = trace[name].clone()


def test_twenty_moco_steps_match_jax_step_by_step():
    """Twenty MoCo steps in f32 (features given, so no dither), the queue
    (K=16) wrapping five times, the LR on its cosine. Each step of the
    port, started from the JAX package's state before that step, gives
    its loss within 1e-4, its queue within 1e-4 of its largest magnitude,
    the same accuracy and pointer. Run freely from the same init, the
    port drifts from the JAX run as the JAX package's own two paths
    (fused_tail True and False, the same math) drift from each other: at
    B=4 each step amplifies rounding ~3-10x. Its largest loss and queue
    deviations over the 20 steps must stay within 3x the JAX paths'
    (printed with -s)."""
    variables, model, encode_fn = _encoders()
    _, free_model, _ = _encoders()
    ecapa = dict(channels=CH, feat_dim=FEAT, embed_dim=EMB,
                 global_context_att=True, fused_block=False)
    unfused = JECAPA(**ecapa, fused_tail=False)

    def encode_unfused(params, stats, feats, train):
        v = {"params": params, "batch_stats": stats}
        if train:
            emb, mut = unfused.apply(v, feats, train=True,
                                     mutable=["batch_stats"])
            return emb, mut["batch_stats"]
        return unfused.apply(v, feats, train=False), stats

    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.0,
                                             momentum=0.9)
    K, m = 16, 0.9
    from wespeaker_tpu.ssl.dino import cosine_scheduler as jcos

    from wespeaker_tpu_torch.ssl.dino import cosine_scheduler
    jstep = jax.jit(JC.make_moco_train_step(encode_fn, tx, jcos(*LR20),
                                            m=m))
    jstep_unfused = jax.jit(JC.make_moco_train_step(
        encode_unfused, tx, jcos(*LR20), m=m))
    state, state_u = (_moco_state(variables, tx, K) for _ in range(2))
    steps = []
    for mod in (model, free_model):
        opt = torch.optim.SGD(mod.parameters(), lr=0.0, momentum=0.9)
        steps.append((C.MoCoTrainStep(mod, opt, cosine_scheduler(*LR20),
                                      torch.from_numpy(np.array(
                                          state.queue)), m=m), opt))
    (forced, forced_opt), (free, _) = steps
    rng = np.random.default_rng(7)
    drift = {"port": [], "jax": []}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    for i in range(20):
        batch = {k: rng.standard_normal((B, T, FEAT)).astype(np.float32)
                 for k in ("q_feat", "k_feat")}
        _sync_moco(forced, forced_opt, state)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        state, jm = jstep(state, jbatch)
        state_u, jm_u = jstep_unfused(state_u, jbatch)
        tm, fm = forced(batch), free(batch)
        _rel_close(float(tm["loss"]), float(jm["loss"]), 1e-4,
                   f"step {i} loss")
        _rel_close(forced.queue, state.queue, 1e-4, f"step {i} queue")
        assert float(tm["acc"]) == float(jm["acc"]), i
        assert forced.queue_ptr == int(state.queue_ptr) == (
            B * (i + 1)) % K
        drift["port"].append((rel(float(fm["loss"]), float(jm["loss"])),
                              rel(free.queue, state.queue)))
        drift["jax"].append((rel(float(jm_u["loss"]), float(jm["loss"])),
                             rel(state_u.queue, state.queue)))
    print("moco free-run (loss, queue) deviations from JAX fused_tail=True,"
          " per step:", drift)
    for j, what in enumerate(("loss", "queue")):
        port = max(d[j] for d in drift["port"])
        ref = max(d[j] for d in drift["jax"])
        assert port <= 3 * max(ref, 1e-6), (what, port, ref)
