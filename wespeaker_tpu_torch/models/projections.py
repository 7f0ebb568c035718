"""Margin-based projection heads (classification losses).

Counterpart of wespeaker_tpu/models/projections.py. Only ArcMargin is
ported. As in the JAX package, the margin is an argument of the call (the
trainer evaluates the margin schedule each step) rather than state that a
scheduler mutates; the weight keeps the upstream name and layout,
`weight` (num_class, embed_dim), so an upstream head loads by name.

Contract: `projection(embed, label, margin)` -> (B, num_class) logits.
"""

import math
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


class ArcMarginProduct(nn.Module):
    """Additive angular margin: cos(theta + m), with the continuity fix
    for theta + m > pi (`th`, `mmm`; upstream projections.py:205-231). Runs
    in f32 on the f32 embedding."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 32.0, easy_margin: bool = False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0) -> torch.Tensor:
        cos_m, sin_m = math.cos(margin), math.sin(margin)
        th = math.cos(math.pi - margin)
        mmm = 1.0 + math.cos(math.pi - margin)
        cosine = F.linear(F.normalize(embed.float(), dim=-1),
                          F.normalize(self.weight.float(), dim=-1))
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
        phi = cosine * cos_m - sine * sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > th, phi, cosine - mmm)
        one_hot = F.one_hot(label.long(), self.out_features).to(cosine.dtype)
        return self.scale * (one_hot * phi + (1.0 - one_hot) * cosine)


def get_projection(conf: Dict[str, Any]) -> nn.Module:
    """Factory with the config of wespeaker_tpu/models/projections.py:250;
    only `arc_margin` is ported."""
    ptype = conf.get("project_type", "linear")
    if ptype != "arc_margin":
        raise KeyError(f"projection {ptype} is not ported yet; the port has "
                       "arc_margin")
    return ArcMarginProduct(conf["embed_dim"], conf["num_class"],
                            scale=conf["scale"],
                            easy_margin=conf.get("easy_margin", False))
