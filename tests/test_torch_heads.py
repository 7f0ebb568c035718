"""Port parity for every projection head of models/projections.py against
the JAX package's flax heads, in f32: the logits, the loss (softmax
cross-entropy, or SphereFace2's own) and the gradients with respect to the
embedding and the head's parameters, each within 1e-5 of its largest
magnitude, at margin 0 and 0.2. The flax parameters cross to the port by
utils/weights.py (from_jax_checkpoint, the JAX trainer's checkpoint tree)
and back by to_jax_projection, exactly; the Linear head's BatchNorm runs
in train mode and its running statistics must match flax's.

HyperbolicAMSoftmax takes embeddings of norm < 1 here. Larger ones are
projected onto the ball's edge, where 1 - |x|^2 is ~2e-5 and one f32
rounding of the norm moves a logit by ~0.1 in either package. Even inside
the ball its embedding gradient is ill-conditioned in f32: at norm ~0.2
both packages' f32 gradients lie 1.1e-5 (the port) and 2.4e-5 (JAX) of
its largest magnitude from the f64 value. So its logits and loss are held
in f32, and the whole case, gradients included, in f64 on both sides
(jax.enable_x64), within the same 1e-5.

SphereProduct's third argument is its iteration count; both packages'
train steps pass the margin schedule's value there (a fault of the
reference, ROADMAP.md Queue 3), and a test pins that the port does as the
JAX package does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from wespeaker_tpu.models import projections as jproj  # noqa: E402
from wespeaker_tpu.utils import checkpoint as jckpt  # noqa: E402
from wespeaker_tpu_torch.models import projections as tproj  # noqa: E402
from wespeaker_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
EMB, NCLS, B = 16, 12, 6

HEADS = {
    "arc_margin": {"project_type": "arc_margin"},
    "arc_margin_easy": {"project_type": "arc_margin", "easy_margin": True},
    "add_margin": {"project_type": "add_margin"},
    "intertopk_subcenter": {"project_type": "arc_margin_intertopk_subcenter",
                            "K": 3, "k_top": 4},
    "intertopk_subcenter_lm": {
        "project_type": "arc_margin_intertopk_subcenter", "do_lm": True},
    "sphereface2_C": {"project_type": "sphereface2"},
    "sphereface2_A": {"project_type": "sphereface2", "margin_type": "A",
                      "t": 2, "lanbuda": 0.6},
    "sphere": {"project_type": "sphere"},
    "ham_margin": {"project_type": "ham_margin", "scale": 30.0,
                   "curvature": 1.0},
    "softmax": {"project_type": "softmax"},
}
F32_GRADS = sorted(set(HEADS) - {"ham_margin"})


def _conf(name):
    return {"embed_dim": EMB, "num_class": NCLS, "scale": 32.0,
            **HEADS[name]}


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    embed = rng.normal(size=(B, EMB)).astype(np.float32)
    if name == "ham_margin":
        embed *= 0.05  # inside the ball (module docstring)
    label = rng.integers(0, NCLS, B).astype(np.int32)
    return embed, label


def _rel_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"


def _jax_head(name, embed, label):
    head = jproj.get_projection(_conf(name))
    variables = head.init(jax.random.PRNGKey(1), jnp.asarray(embed),
                          jnp.asarray(label))
    return head, variables


def _port_head(name, variables):
    """The port's head with the flax variables carried by the checkpoint
    mapping, as a JAX trainer's .ckpt would carry them."""
    tree = {"params": {}, "projection": variables["params"]}
    if "batch_stats" in variables:
        tree["projection_batch_stats"] = variables["batch_stats"]
    _, sd = weights.from_jax_checkpoint(tree, "ECAPA_TDNN")
    head = tproj.get_projection(_conf(name))
    head.load_state_dict(sd, strict=True)
    return head


def _jax_loss(head, variables, embed, label, margin, train):
    def fn(params, e):
        v = dict(variables, params=params)
        if "batch_stats" in variables:
            out, mut = head.apply(v, e, label, margin, train=train,
                                  mutable=["batch_stats"])
        else:
            out, mut = head.apply(v, e, label, margin), {}
        if isinstance(out, tuple):
            logits, loss = out
        else:
            logits = out
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, label).mean()
        return loss, (logits, mut)

    (loss, (logits, mut)), grads = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                           jnp.asarray(embed))
    return loss, logits, grads, mut


def _check_head(name, margin, dtype, grads=True):
    embed, label = _inputs(name)
    jhead, variables = _jax_head(name, embed, label)
    head = _port_head(name, variables).to(dtype)
    train = name == "softmax"
    head.train(train)
    if dtype == torch.float64:
        embed = embed.astype(np.float64)
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables)
    jl, jlogits, (jgp, jge), mut = _jax_loss(
        jhead, variables, jnp.asarray(embed), jnp.asarray(label), margin,
        train)

    e = torch.from_numpy(embed).requires_grad_(True)
    out = head(e, torch.from_numpy(label), margin)
    if isinstance(out, tuple):
        logits, loss = out
    else:
        logits = out
        loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(
            label).long())
    loss.backward()
    assert logits.shape == (B, NCLS) and logits.dtype == dtype
    assert np.asarray(jlogits).dtype == np.dtype(str(dtype)[6:])
    _rel_close(logits.detach(), jlogits, 1e-5, f"{name} logits")
    _rel_close(loss.item(), float(jl), 1e-5, f"{name} loss")
    if not grads:
        return
    _rel_close(e.grad, jge, 1e-5, f"{name} d embed")
    got = weights.to_jax_projection({k: p.grad for k, p in
                                     head.named_parameters()})["projection"]
    for path, g in _flat(jgp):
        _rel_close(_get(got, path), g, 1e-5, f"{name} d {'/'.join(path)}")
    if train:
        stats = weights.to_jax_projection(head.state_dict())[
            "projection_batch_stats"]
        for path, v in _flat(mut["batch_stats"]):
            _rel_close(_get(stats, path), v, 1e-6, f"running {path}")


@pytest.mark.parametrize("margin", [0.0, 0.2])
@pytest.mark.parametrize("name", F32_GRADS)
def test_head_matches_flax(name, margin):
    _check_head(name, margin, torch.float32)


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_ham_margin_matches_flax(margin):
    """f32 logits and loss; logits, loss and gradients in f64 (module
    docstring)."""
    _check_head("ham_margin", margin, torch.float32, grads=False)
    with jax.enable_x64(True):
        _check_head("ham_margin", margin, torch.float64)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_crosses_checkpoints_both_ways(name, tmp_path):
    """to_jax_projection inverts the mapping bit for bit; the JAX trainer's
    .ckpt and the port's .pt both load the head."""
    embed, label = _inputs(name)
    _, variables = _jax_head(name, embed, label)
    head = _port_head(name, variables)
    back = weights.to_jax_projection(head.state_dict())
    want = dict(_flat(variables["params"]))
    got = dict(_flat(back["projection"]))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], v)
    assert ("projection_batch_stats" in back) == ("batch_stats" in variables)
    model = torch.nn.Linear(2, 2)  # a stand-in with no flax rules
    tree = {"params": {"kernel": np.zeros((2, 2), np.float32),
                       "bias": np.zeros(2, np.float32)},
            "projection": variables["params"]}
    if "batch_stats" in variables:
        tree["projection_batch_stats"] = variables["batch_stats"]
    jckpt.save_checkpoint(str(tmp_path / "model_0.ckpt"), tree)
    for path in (tmp_path / "model_0.ckpt", tmp_path / "model_0.pt"):
        if path.suffix == ".pt":
            tckpt.save_checkpoint(str(path), model, head)
        fresh = tproj.get_projection(_conf(name))
        tckpt.load_checkpoint(str(path), model, fresh)
        for k, v in head.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), (path, k)


def test_get_projection_defaults_match_jax():
    for name in HEADS:
        want = jproj.get_projection(_conf(name))
        got = tproj.get_projection(_conf(name))
        assert type(got).__name__ == type(want).__name__
        for field in ("scale", "easy_margin", "K", "mp", "k_top", "do_lm",
                      "lanbuda", "t", "margin_type", "margin", "base",
                      "gamma", "power", "lambda_min", "curvature"):
            if hasattr(want, field):
                assert getattr(got, field) == getattr(want, field), (name,
                                                                     field)
    assert isinstance(tproj.get_projection({"embed_dim": 4, "num_class": 3}),
                      tproj.LinearProjection)


class _SpyJ(jproj.SphereProduct):
    seen = []

    def __call__(self, embed, label, it=0):
        type(self).seen.append(float(it))
        return super().__call__(embed, label, it)


class _SpyT(tproj.SphereProduct):
    seen = []

    def forward(self, embed, label, it=0):
        type(self).seen.append(float(it))
        return super().forward(embed, label, it)


def test_sphere_product_gets_the_margin_as_its_iteration():
    """Both packages' train steps pass margin_fn(step) as SphereProduct's
    `it`: at step 7 of a schedule whose margin is 0.2, `it` is 0.2, so
    lambda is 1000 / 1.024 (near `base`) and the A-Softmax target logit
    moves by < 1% of its margin term. The port keeps the fault."""
    from wespeaker_tpu.train import init_train_state
    from wespeaker_tpu.train import make_train_step as j_make_train_step
    from wespeaker_tpu.train.train_step import AugConfig as JAug
    from wespeaker_tpu.frontend import FbankConfig as JFbank
    from wespeaker_tpu_torch.frontend import FbankConfig
    from wespeaker_tpu_torch.train import AugConfig, make_train_step

    feat = np.random.default_rng(2).normal(size=(B, 20, 8)).astype(
        np.float32)
    label = np.arange(B, dtype=np.int32) % NCLS

    class Pool(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(8, EMB)

        def forward(self, x):
            return self.lin(x.mean(1))

    _SpyT.seen.clear()
    model, head = Pool(), _SpyT(EMB, NCLS)
    step = make_train_step(
        model, head, torch.optim.SGD(list(model.parameters())
                                     + list(head.parameters()), lr=0.1),
        lambda s: 0.1, lambda s: 0.2, FbankConfig(dither=0.0),
        AugConfig(spec_aug=False), device="cpu")
    step.step = 7
    step({"feat": feat, "label": label})
    assert _SpyT.seen == [0.2]

    import flax.linen as nn

    class JPool(nn.Module):
        @nn.compact
        def __call__(self, x, train=False, mask=None):
            return nn.BatchNorm(use_running_average=not train)(
                nn.Dense(EMB)(x.mean(1)))

    _SpyJ.seen.clear()
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.1)
    jhead = _SpyJ(EMB, NCLS)
    state = init_train_state(JPool(), jhead, tx, jax.random.PRNGKey(0),
                             feat_dim=8, embed_dim=EMB)
    _SpyJ.seen.clear()
    jstep = j_make_train_step(JPool(), jhead, tx, lambda s: 0.1,
                              lambda s: 0.2, JFbank(dither=0.0),
                              JAug(spec_aug=False))
    jstep(state.replace(step=jnp.asarray(7, jnp.int32)),
          {"feat": jnp.asarray(feat), "label": jnp.asarray(label)})
    assert _SpyJ.seen == [pytest.approx(0.2)]

    # lambda at it = 0.2 against the annealed one at iteration 7
    embed, lab = _inputs("sphere")
    _, variables = _jax_head("sphere", embed, lab)
    head = _port_head("sphere", variables)
    e, t = torch.from_numpy(embed), torch.from_numpy(lab)
    plain = head(e, t, 0.0)
    margin_term = head(e, t, 1e9) - plain  # lambda at its floor, 5
    at_margin = head(e, t, 0.2) - plain
    ratio = (at_margin.abs().sum() / margin_term.abs().sum()).item()
    # out = cos + [target] (phi - cos) / (1 + lambda), times |x|
    want = ((1 / (1 + 1000 / 1.024) - 1 / 1001)
            / (1 / 6 - 1 / 1001))
    assert ratio == pytest.approx(want, rel=1e-3) and ratio < 1e-3
