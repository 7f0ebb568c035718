"""LoRA over the port's named parameters.

Counterpart of wespeaker_tpu/utils/lora.py (upstream PEFT LoRA on the
w2v-bert frontend, wespeaker/frontend/w2vbert.py:46-77, and
tools/merge_lora.py). A 2-D weight whose dotted name matches
`target_pattern` (the JAX package's pattern, its `/kernel` written
`.weight` for the port's names: q_proj, k_proj, v_proj, out_proj, query,
key, value and out, so w2v-bert's `linear_out` too, as `re.search` finds
it there in both) gets an adapter a (in, r) ~ N(0, 1/r) from an explicit
torch.Generator and b (r, out) = 0; the scaling is alpha / r. The delta
scaling * a @ b is in flax's (in, out) layout, so it is transposed onto
torch's (out, in) weight. As in the JAX package, the trainer does not
wire LoRA in (its composite drops `use_lora`); `apply_lora` makes the
adapted state for torch.func.functional_call, `merge_lora` folds them
into a plain state_dict. The bitsandbytes 4-bit path is not reproduced,
as in the JAX package.
"""

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

DEFAULT_TARGET = r"(q_proj|k_proj|v_proj|out_proj|query|key|value|out)\.weight$"

Adapters = Dict[str, Dict[str, torch.Tensor]]


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def init_lora_params(params, rank: int = 8, alpha: float = 16.0,
                     target_pattern: str = DEFAULT_TARGET,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Adapters, float]:
    """({name: {"a": (in, r), "b": (r, out)}}, alpha / rank) for every 2-D
    weight of `params` (a module or a {name: tensor} mapping) whose name
    matches `target_pattern`, in the mapping's order; a is drawn from
    `generator` (a fresh one seeded 0 if None), on the weight's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    adapters = {}
    for name, w in _named(params).items():
        if w.dim() == 2 and re.search(target_pattern, name):
            out_dim, in_dim = w.shape
            a = torch.randn((in_dim, rank), generator=generator,
                            device=generator.device) / math.sqrt(rank)
            adapters[name] = {"a": a.to(w.device),
                              "b": torch.zeros((rank, out_dim),
                                               device=w.device)}
    return adapters, alpha / rank


def _delta(ab: Mapping[str, torch.Tensor], scaling: float) -> torch.Tensor:
    """scaling * a @ b, (in, out), as torch's (out, in)."""
    return (scaling * (ab["a"] @ ab["b"])).t()


def apply_lora(params, adapters: Adapters,
               scaling: float) -> Dict[str, torch.Tensor]:
    """{name: W + scaling * (a @ b)^T} for the adapted weights, the rest
    as they are: a state for torch.func.functional_call in which the
    gradient reaches the adapters (and the base weights, unless they are
    detached or frozen)."""
    out = dict(_named(params))
    for name, ab in adapters.items():
        out[name] = out[name] + _delta(ab, scaling).to(out[name].dtype)
    return out


def merge_lora(state_dict: Mapping[str, torch.Tensor], adapters: Adapters,
               scaling: float) -> Dict[str, torch.Tensor]:
    """The adapters folded into a plain state_dict (tools/merge_lora.py's
    role), detached."""
    out = {k: v.detach() for k, v in state_dict.items()}
    with torch.no_grad():
        for name, ab in adapters.items():
            out[name] = out[name] + _delta(ab, scaling).to(out[name].dtype)
    return out


def lora_train_mask(params, adapters: Adapters) -> Dict[str, dict]:
    """{"base": {name: False}, "lora": {name: {"a": True, "b": True}}}:
    only the adapters train, the base stays frozen (the JAX package's
    optax mask)."""
    return {"base": {k: False for k in _named(params)},
            "lora": {k: {n: True for n in ab} for k, ab in adapters.items()}}
