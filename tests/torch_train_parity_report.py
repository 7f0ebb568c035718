"""Where the port's CAMPPlus and Gemini training part from the JAX
package's, in numbers, on the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_train_parity_report

For each family at tests/test_torch_train_families.py's narrow width and
batch (B=4 x 40 frames, feat 16) it prints:
- the two-step errors of that test (loss and accuracy at each step; the
  BN statistics after both) at LR 1e-7 and 1e-4;
- one train-mode forward and the parameter gradients of a fixed linear
  function of the embedding, port against JAX from the same weights, in
  f32 and in f64: the embedding's largest error relative to its largest
  magnitude, and the largest gradient error relative to its tensor's
  2-norm (with that tensor's name), beside the largest gradient norm.
What f32 leaves and f64 does not is rounding, not a difference of method.
It takes ~10 minutes (the JAX CAMPPlus train step compiles for each LR,
and its f64 gradients run without jit).
"""

import numpy as np
import torch

import jax

from tests.test_torch_train_families import (CAM_KW, FAMILIES, FEAT,
                                             GEMINI_KW, two_step_errors)
from wespeaker_tpu.models.campplus import CAMPPlus as JCAMPPlus
from wespeaker_tpu.models.gemini_dfresnet import Gemini_DF_ResNet as JGemini
from wespeaker_tpu_torch.models.campplus import CAMPPlus
from wespeaker_tpu_torch.models.gemini_dfresnet import Gemini_DF_ResNet
from wespeaker_tpu_torch.utils import weights

MODELS = {"CAMPPlus": (JCAMPPlus, CAMPPlus, CAM_KW),
          "Gemini": (JGemini, Gemini_DF_ResNet, GEMINI_KW)}


def forward_and_grads(family, dtype):
    """(embedding error, (gradient error, name), largest gradient norm) of
    one train-mode forward and the gradients of sum(emb * r)."""
    import jax.numpy as jnp

    jcls, tcls, kw = MODELS[family]
    rules = FAMILIES[family][2]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 40, FEAT)).astype(dtype)
    r = rng.normal(size=(4, kw["embed_dim"])).astype(dtype)
    jm = jcls(**kw)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype),
        jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros(
            (1, 40, FEAT), dtype))))

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(r)), out

    (_, want), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
    want_g = weights.from_jax_variables({"params": jax.device_get(g)}, rules)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = tcls(**kw)
    model.load_state_dict(weights.from_jax_variables(v, rules), strict=True)
    model = model.to(tdtype).train()
    out = model(torch.from_numpy(x))
    (out * torch.from_numpy(r)).sum().backward()
    want = np.asarray(want)
    emb_err = float(np.abs(out.detach().numpy() - want).max()
                    / np.abs(want).max())
    worst, top = (0.0, ""), 0.0
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        w = want_g[name].double()
        top = max(top, w.norm().item())
        err = ((p.grad.double() - w).norm() / max(w.norm().item(), 1e-30)
               ).item()
        worst = max(worst, (err, name))
    return emb_err, worst, top


def main():
    torch.set_num_threads(2)
    for family in FAMILIES:
        for lr in (1e-7, 1e-4):
            errs = two_step_errors(family, lr)
            print(f"{family} two steps at LR {lr:g}: " + ", ".join(
                f"{k} " + " ".join(f"{v:.3g}" for v in np.atleast_1d(
                    errs[k]))
                for k in ("loss", "acc", "running_var", "running_mean")))
    jax.config.update("jax_enable_x64", True)
    for family in FAMILIES:
        for dtype in (np.float32, np.float64):
            emb, (gerr, gname), top = forward_and_grads(family, dtype)
            print(f"{family} train-mode forward {np.dtype(dtype).name}: "
                  f"embedding {emb:.3g} of its max; worst gradient "
                  f"{gerr:.3g} of its norm ({gname}); largest gradient "
                  f"norm {top:.3g}")


if __name__ == "__main__":
    main()
