"""Seeded numpy weights for the JAX package's flax models, shared by the
port's model-zoo parity tests: the tree's shapes come from
`jax.eval_shape` of the module's init (no init compile), its values from
numpy."""

import numpy as np
import jax
from flax.core import unfreeze
from flax.linen import meta
from flax.traverse_util import flatten_dict, unflatten_dict


def numpy_variables(module, example, seed, stats=True, **init_kw):
    """{"params", "batch_stats"} for `module` at input `example`: conv and
    dense kernels normal with std 1/sqrt(fan_in), every other parameter
    (biases, norm scales as 1 + noise, priors, stage weights) 0.1 normal;
    BN means 0.1 normal and variances uniform in [0.5, 1.5], or with
    stats=False flax's own init of them (0 and 1) and of the norms' scale
    and bias (1 and 0)."""
    # unboxed: the SSL frontends' kernels carry logical partitioning
    shapes = meta.unbox(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), example, **init_kw)))
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in flatten_dict(unfreeze(shapes)).items():
        shape, leaf = tuple(s.shape), path[-1]
        noise = rng.normal(size=shape)
        if path[0] == "batch_stats":
            if not stats:
                v = np.zeros(shape) if leaf == "mean" else np.ones(shape)
            else:
                v = (0.1 * noise if leaf == "mean"
                     else rng.uniform(0.5, 1.5, shape))
        elif leaf == "kernel":
            v = noise / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.1 * noise if stats else np.ones(shape)
        elif leaf == "bias" and not stats:
            v = np.zeros(shape)
        else:
            v = 0.1 * noise
        out[path] = v.astype(np.float32)
    return unflatten_dict(out)


def torch_shapes(module, example, model_name, **init_kw):
    """{port state_dict key: shape} that the JAX module's variables map to
    (jax.eval_shape of its init, the port's name rules and kernel
    layouts, a composite's by utils/weights.py's "<frontend>+<model>"
    names); BatchNorm counters, which flax does not keep, left out."""
    from wespeaker_tpu_torch.utils import weights

    shapes = unfreeze(meta.unbox(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), example, **init_kw))))
    # a composite ("<frontend family>+<speaker model>") names each of its
    # two subtrees by its own rules, under its prefix
    parts = ([((), model_name)] if "+" not in model_name else
             [((p,), n) for p, n in zip(weights.COMPOSITE_PARTS,
                                        model_name.split("+"))])
    out = {}
    for prefix, name in parts:
        rules = weights.rules_for(name)
        for collection in ("params", "batch_stats"):
            tree = shapes.get(collection, {})
            for k in prefix:
                tree = tree.get(k, {})
            for (*mods, leaf), s in flatten_dict(tree).items():
                shape = tuple(s.shape)
                if leaf == "kernel":
                    shape = tuple(shape[i] for i in
                                  weights._KERNEL_AXES[len(shape)])
                key = weights._torch_key(tuple(mods), leaf, rules)
                out[".".join(prefix + (key,))] = shape
    return out


def port_shapes(model):
    """{key: shape} of a port model's state_dict, counters left out."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
