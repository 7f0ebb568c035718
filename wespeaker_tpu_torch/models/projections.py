"""Margin-based projection heads (classification losses).

Counterpart of wespeaker_tpu/models/projections.py (upstream
wespeaker/models/projections.py: get_projection:25, SphereFace2:72,
ArcMarginProduct:175, ArcMarginProduct_intertopk_subcenter:249,
AddMarginProduct:375, SphereProduct:417, HyperbolicAMSoftmax:477,
Linear:559). As in the JAX package, the margin is an argument of the call
(the trainer evaluates the margin schedule each step) rather than state
that a scheduler mutates. Parameters keep the JAX package's names and
layouts, which are upstream's: the margin heads' `weight` is (rows,
embed_dim), SphereFace2's `bias` (1, 1), the Linear head's
`trans_bn.*` and `trans_linear.*`; so utils/weights.py carries each head
between the packages' checkpoints by name.

Contract: `projection(embed, label, margin)` -> (B, num_class) logits, or
(logits, loss) for a head that computes its own loss (SphereFace2). Every
head computes in f32 on the f32 embedding (f64 on an f64 one). The Linear
head carries a BatchNorm: in train mode (module.training) it normalises by
the batch and updates its running statistics as flax does
(models/layers.py::batch_norm).

The model axis (`parallel_args.model > 1`): `shard_rows` keeps a rank's
rows of a head's `weight` ((rows, embed_dim), the parameter the JAX
trainer shards over 'model'; the Linear head holds none and stays whole),
and the head computes its logits of those rows and gathers them over the
model group before the margin and the loss, as GSPMD inserts the logits
all-gather (parallel/collect.py: the gather's backward takes this rank's
slot, the embedding's gradient is summed over the group). `full_state_dict`
gathers the rows back, so a checkpoint holds the whole head.
"""

import math
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import batch_norm, wide
from wespeaker_tpu_torch.parallel.collect import (all_gather_embeddings,
                                                  all_gather_rows,
                                                  copy_to_group)
from wespeaker_tpu_torch.parallel.mesh import group_rank, group_size


def _margin_weight(rows: int, in_features: int) -> nn.Parameter:
    """(rows, in_features) drawn as torch's xavier_uniform_ (flax's
    variance_scaling(1, fan_avg, uniform) in the JAX package)."""
    w = nn.Parameter(torch.empty(rows, in_features))
    nn.init.xavier_uniform_(w)
    return w


def _cosine(embed: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    embed = wide(embed)
    return F.linear(F.normalize(embed, dim=-1),
                    F.normalize(weight.to(embed.dtype), dim=-1))


def _rows(head: nn.Module, embed: torch.Tensor, fn) -> torch.Tensor:
    """fn(embed, weight) -> (B, rows) over the head's `weight`; over a
    model group (shard_rows) each rank's rows, gathered in rank order."""
    group = getattr(head, "model_group", None)
    if group is None:
        return fn(embed, head.weight)
    return all_gather_rows(fn(copy_to_group(embed, group), head.weight),
                           group, dim=-1, backward="slice")


def shard_rows(head: nn.Module, group) -> nn.Module:
    """Keep this rank's block of the rows of `head.weight` over the model
    `group` (rank order, equal blocks; the trainer pads the classes to a
    multiple of the group's size). A head without such a weight, or a
    group of one rank, is left whole. Returns the head."""
    n = group_size(group)
    weight = getattr(head, "weight", None)
    if n == 1 or not isinstance(weight, nn.Parameter):
        return head
    if weight.shape[0] % n:
        raise ValueError(f"{weight.shape[0]} head rows do not split over "
                         f"{n} model ranks")
    head.weight = nn.Parameter(
        weight.detach().chunk(n)[group_rank(group)].clone())
    head.model_group = group
    return head


def full_state_dict(head: nn.Module):
    """The head's state_dict with a sharded `weight` gathered back to all
    its rows; a collective over the model group (every rank calls it)."""
    sd = head.state_dict()
    group = getattr(head, "model_group", None)
    if group is not None:
        sd["weight"] = all_gather_embeddings(sd["weight"], group)
    return sd


def _one_hot(label: torch.Tensor, n: int, like: torch.Tensor
             ) -> torch.Tensor:
    return F.one_hot(label.long(), n).to(like.dtype)


def _arc(cosine: torch.Tensor, margin: float, easy_margin: bool):
    """cos(theta + m) with upstream's continuity fix for theta + m > pi
    (`th`, `mmm`), or cosine where cosine <= 0 with easy_margin."""
    cos_m, sin_m = math.cos(margin), math.sin(margin)
    th = math.cos(math.pi - margin)
    mmm = 1.0 + math.cos(math.pi - margin)
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine), sine
    return torch.where(cosine > th, phi, cosine - mmm), sine


class ArcMarginProduct(nn.Module):
    """Additive angular margin: cos(theta + m) (upstream
    projections.py:205-231)."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 32.0, easy_margin: bool = False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.easy_margin = easy_margin
        self.weight = _margin_weight(out_features, in_features)

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0) -> torch.Tensor:
        cosine = _rows(self, embed, _cosine)
        phi, _ = _arc(cosine, margin, self.easy_margin)
        one_hot = _one_hot(label, self.out_features, cosine)
        return self.scale * (one_hot * phi + (1.0 - one_hot) * cosine)


class AddMarginProduct(nn.Module):
    """Additive cosine margin: cos(theta) - m (CosFace)."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 32.0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.weight = _margin_weight(out_features, in_features)

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0) -> torch.Tensor:
        cosine = _rows(self, embed, _cosine)
        one_hot = _one_hot(label, self.out_features, cosine)
        return self.scale * (cosine - one_hot * margin)


class ArcMarginIntertopkSubcenter(nn.Module):
    """Sub-centre ArcFace with the inter-top-k penalty (arXiv:2110.05042,
    upstream projections.py:249-372): K sub-centres a class (rows c*K ..
    c*K + K - 1 of `weight`), the class cosine their largest; the k_top
    hardest wrong classes get cos(theta - mp), with mp ramped by the
    margin (mp * margin / 0.2 above 0.001). `do_lm` (large-margin
    fine-tune) turns both penalties off."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 32.0, easy_margin: bool = False, K: int = 3,
                 mp: float = 0.06, k_top: int = 5, do_lm: bool = False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.easy_margin = easy_margin
        self.K = K
        self.mp = mp
        self.k_top = k_top
        self.do_lm = do_lm
        self.weight = _margin_weight(K * out_features, in_features)

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0) -> torch.Tensor:
        mp = 0.0 if self.do_lm else self.mp
        k_top = 0 if self.do_lm else self.k_top
        mp_eff = mp * (margin / 0.2) if margin > 0.001 else 0.0
        cos_mp, sin_mp = math.cos(mp_eff), math.sin(mp_eff)
        cosine = _rows(self, embed, _cosine).reshape(
            -1, self.out_features, self.K).amax(dim=2)
        phi, sine = _arc(cosine, margin, self.easy_margin)
        phi_mp = cosine * cos_mp + sine * sin_mp
        one_hot = _one_hot(label, self.out_features, cosine)
        if k_top > 0:
            idx = torch.topk(cosine - 2 * one_hot, k_top, dim=-1).indices
            top_k = torch.zeros_like(cosine).scatter_(1, idx, 1.0)
            out = (one_hot * phi + top_k * phi_mp
                   + (1.0 - one_hot - top_k) * cosine)
        else:
            out = one_hot * phi + (1.0 - one_hot) * cosine
        return self.scale * out


class SphereFace2(nn.Module):
    """SphereFace2's binary-classification margin loss (upstream
    projections.py:72-172), margin types "A" (angular) and "C" (cosine,
    the default); returns (logits, loss)."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 32.0, lanbuda: float = 0.7, t: int = 3,
                 margin_type: str = "C"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.lanbuda = lanbuda
        self.t = t
        self.margin_type = margin_type
        self.weight = _margin_weight(out_features, in_features)
        self.bias = nn.Parameter(torch.zeros(1, 1))

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0):
        cos = _rows(self, embed, _cosine)

        def fun_g(z):
            return 2.0 * ((z + 1.0) / 2.0) ** self.t - 1.0

        b = self.bias[0, 0].to(cos.dtype)
        if self.margin_type == "A":
            phi, sin = _arc(cos, margin, easy_margin=False)
            pos = self.scale * fun_g(phi) + b
            neg = self.scale * fun_g(cos * math.cos(margin)
                                     + sin * math.sin(margin)) + b
        else:
            pos = self.scale * (fun_g(cos) - margin) + b
            neg = self.scale * (fun_g(cos) + margin) + b
        cos_p = self.lanbuda * torch.log1p(torch.exp(-pos))
        cos_n = (1 - self.lanbuda) * torch.log1p(torch.exp(neg))
        target = _one_hot(label, self.out_features, cos)
        logits = self.scale * ((cos - margin) * target + cos * (1 - target))
        loss = (target * cos_p + (1 - target) * cos_n).sum(dim=1).mean()
        return logits, loss


class SphereProduct(nn.Module):
    """A-Softmax, cos(m theta) (upstream projections.py:417-474). The
    third argument is the iteration `it` of the lambda annealing,
    lambda = max(lambda_min, base (1 + gamma it)^-power). The trainers of
    both packages pass the margin schedule's value there, as for every
    head, so lambda stays near `base` and the margin barely acts; the
    port keeps that behaviour of the JAX package."""

    _MLAMBDA = (
        lambda x: x * 0 + 1, lambda x: x, lambda x: 2 * x ** 2 - 1,
        lambda x: 4 * x ** 3 - 3 * x, lambda x: 8 * x ** 4 - 8 * x ** 2 + 1,
        lambda x: 16 * x ** 5 - 20 * x ** 3 + 5 * x,
    )

    def __init__(self, in_features: int, out_features: int, margin: int = 4,
                 base: float = 1000.0, gamma: float = 0.12,
                 power: float = 1.0, lambda_min: float = 5.0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.margin = margin
        self.base, self.gamma = base, gamma
        self.power, self.lambda_min = power, lambda_min
        self.weight = _margin_weight(out_features, in_features)

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                it: float = 0) -> torch.Tensor:
        lamb = max(self.lambda_min,
                   self.base * (1 + self.gamma * it) ** (-self.power))
        embed = wide(embed)
        cos_theta = torch.clamp(_rows(self, embed, _cosine), -1, 1)
        cos_m_theta = self._MLAMBDA[self.margin](cos_theta)
        k = torch.floor(self.margin * torch.arccos(cos_theta) / math.pi)
        sign = 1.0 - 2.0 * torch.remainder(k, 2.0)  # (-1)^k
        phi_theta = sign * cos_m_theta - 2 * k
        feat_norm = torch.linalg.vector_norm(embed, dim=1, keepdim=True)
        one_hot = _one_hot(label, self.out_features, cos_theta)
        out = one_hot * (phi_theta - cos_theta) / (1 + lamb) + cos_theta
        return out * feat_norm


class HyperbolicAMSoftmax(nn.Module):
    """Additive-margin softmax on the Poincare ball (upstream
    projections.py:477-556): logits -scale (d(x, w) + m [target])."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 30.0, curvature: float = 1.0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scale = scale
        self.curvature = curvature
        self.weight = nn.Parameter(
            1e-3 * torch.randn(out_features, in_features))

    def proj_to_ball(self, x: torch.Tensor, eps: float = 1e-5):
        norm = torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)
        max_norm = (1.0 - eps) / (self.curvature ** 0.5)
        return x * torch.clamp(max_norm / norm, max=1.0)

    def _distance(self, embed: torch.Tensor, weight: torch.Tensor
                  ) -> torch.Tensor:
        """(B, rows) Poincare distances of the embeddings to the rows."""
        eps = 1e-5
        x = self.proj_to_ball(embed)                     # (B, D)
        w = self.proj_to_ball(weight.to(x.dtype))        # (C, D)
        xn = torch.clamp(torch.linalg.vector_norm(x, dim=-1), 0.0, 1 - eps)
        wn = torch.clamp(torch.linalg.vector_norm(w, dim=-1), 0.0, 1 - eps)
        diff2 = ((x[:, None, :] - w[None, :, :]) ** 2).sum(-1)
        denom = torch.clamp((1 - xn[:, None] ** 2) * (1 - wn[None, :] ** 2),
                            min=eps)
        return torch.arccosh(torch.clamp(1 + 2 * diff2 / denom,
                                         min=1.0 + eps))

    def forward(self, embed: torch.Tensor, label: torch.Tensor,
                margin: float = 0.0) -> torch.Tensor:
        dist = _rows(self, wide(embed), self._distance)
        one_hot = _one_hot(label, self.out_features, dist)
        return -self.scale * (dist + one_hot * margin)


class LinearProjection(nn.Module):
    """The plain softmax head: BatchNorm -> ReLU -> Linear (upstream
    projections.py:559-573). The BatchNorm is flax's (momentum 0.9, eps
    1e-5, the biased batch variance)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.trans_bn = nn.BatchNorm1d(in_features, eps=1e-5, momentum=0.1)
        self.trans_linear = nn.Linear(in_features, out_features)

    def forward(self, embed: torch.Tensor, label: torch.Tensor = None,
                margin: float = 0.0) -> torch.Tensor:
        h = torch.relu(batch_norm(wide(embed), self.trans_bn))
        return F.linear(h, self.trans_linear.weight.to(h.dtype),
                        self.trans_linear.bias.to(h.dtype))


def get_projection(conf: Dict[str, Any]) -> nn.Module:
    """The head of `conf` with the JAX package's defaults
    (wespeaker_tpu/models/projections.py:250; upstream
    projections.py:25-69): `project_type` add_margin, arc_margin,
    arc_margin_intertopk_subcenter, sphere, sphereface2 or ham_margin;
    any other (softmax, linear, the default) is the Linear head."""
    ptype = conf.get("project_type", "linear")
    embed_dim, num_class = conf["embed_dim"], conf["num_class"]
    if ptype == "add_margin":
        return AddMarginProduct(embed_dim, num_class, scale=conf["scale"])
    if ptype == "arc_margin":
        return ArcMarginProduct(embed_dim, num_class, scale=conf["scale"],
                                easy_margin=conf.get("easy_margin", False))
    if ptype == "arc_margin_intertopk_subcenter":
        return ArcMarginIntertopkSubcenter(
            embed_dim, num_class, scale=conf["scale"],
            easy_margin=conf.get("easy_margin", False),
            K=conf.get("K", 3), mp=conf.get("mp", 0.06),
            k_top=conf.get("k_top", 5), do_lm=conf.get("do_lm", False))
    if ptype == "sphere":
        return SphereProduct(embed_dim, num_class, margin=4)
    if ptype == "sphereface2":
        return SphereFace2(embed_dim, num_class, scale=conf["scale"],
                           t=conf.get("t", 3),
                           lanbuda=conf.get("lanbuda", 0.7),
                           margin_type=conf.get("margin_type", "C"))
    if ptype == "ham_margin":
        return HyperbolicAMSoftmax(embed_dim, num_class, scale=conf["scale"],
                                   curvature=conf.get("curvature", 1.0))
    return LinearProjection(embed_dim, num_class)
