"""The recipe YAMLs' composites embed as the JAX package's.

A tiny copy of each WavLM + ECAPA YAML of test_torch_frontend_composite.py
(the frontend cut to width 32 and 2 layers by its TINY, the head as the
YAML has it) embeds a masked ragged batch through the port's eval hook
and make_eval_embed_fn within 1e-5 of the largest magnitude of the JAX
package's embeddings (its eval hook and model in one jitted program),
with the same weights (seeded numpy, carried by utils/weights.py). The
same check of the w2v-bert YAMLs' copies is in test_torch_w2vbert.py, of
the Whisper-PMFA YAMLs' (and a JAX composite `.ckpt` both ways) in
test_torch_whisper.py, with `recipe_pair` and `_port` from here.
"""

import json

import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_frontend_composite import (  # noqa: E402
    YAMLS, _configs, _frontend, _rel_err, _tiny, _wavs)
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu.train.composite import build_model as j_build  # noqa
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import (build_model,  # noqa: E402
                                                 featurizers)
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_variables, rules_name)

torch.set_num_threads(2)


_PAIRS = {}


def recipe_pair(configs):
    """(JAX BuiltModel, jitted apply, variables) for a tiny config; one
    compile for the YAMLs that share an architecture."""
    key = json.dumps({k: configs[k] for k in ("model", "model_args")}
                     | {"fe": {k: v for k, v in configs["dataset_args"].get(
                         f"{_frontend(configs)}_args").items()
                         if k != "frozen"}}, sort_keys=True)
    if key not in _PAIRS:
        jb = j_build(configs)
        featurize = jax.jit(lambda w, m: jb.featurize_eval({"wav": w,
                                                           "mask": m}))
        wav, mask = _wavs(0)
        feat, fmask = featurize(jnp.asarray(wav), jnp.asarray(mask))
        variables = numpy_variables(jb.model, feat, seed=1, mask=fmask,
                                    train=False)

        # the hook and the model in one jitted program
        @jax.jit
        def apply(v, w, m):
            x, fm = jb.featurize_eval({"wav": w, "mask": m})
            return jb.model.apply(v, x, mask=fm, train=False)

        _PAIRS[key] = (jb, apply, variables)
    return _PAIRS[key]


def _port(configs, variables):
    model = build_model(configs)
    sd = from_jax_variables(variables, rules_name(model))
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("path", YAMLS[:2], ids=lambda p: p.stem)
def test_recipe_composite_embeds_as_jax(path):
    configs = _tiny(_configs(path))
    jb, apply, variables = recipe_pair(configs)
    wav, mask = _wavs(2)
    want = apply(variables, jnp.asarray(wav), jnp.asarray(mask))
    fn = make_eval_embed_fn(_port(configs, variables), device="cpu",
                            featurize_fn=featurizers(configs)[1])
    got = fn({"wav": wav, "mask": mask})
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5
