"""Weights between the JAX package, upstream checkpoints and the port.

`from_jax_variables` turns the JAX package's flax variable tree
({"params", "batch_stats"} as nested dicts of arrays) into the port's
state_dict. It inverts the rules of wespeaker_tpu/utils/torch_compat.py:

  - conv kernel (K, I, O) -> weight (O, I, K); 2-D conv kernel
    (kh, kw, I, O) -> weight (O, I, kh, kw)
  - dense kernel (I, O)   -> weight (O, I)
  - BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var, plus num_batches_tracked = 0, which flax does not keep
  - child names by model, chosen from the model's name as
    torch_compat.rules_for chooses them (the longest matching prefix of
    `MODEL_RULES`): ECAPA block_<i> -> se_res2block.<i>, convs_<i> ->
    convs.<i>, bns_<i> -> bns.<i>; CAMPPlus layer<n>_<m> -> layer<n>.<m>,
    shortcut_conv / shortcut_bn -> shortcut.0 / shortcut.1,
    out_nonlinear_bn -> out_nonlinear.batchnorm, nonlinear<n>_bn ->
    nonlinear<n>.batchnorm; Gemini downsample_layers_<i>_<j> ->
    downsample_layers.<i>.<j>, stages_<i>_<j> -> stages.<i>.<j> (a
    depthwise kernel (3, 3, 1, 4C) becomes the (4C, 1, 3, 3) weight);
    ResNet layer<n>_<m> -> layer<n>.<m>, shortcut_conv / shortcut_bn ->
    shortcut.0 / shortcut.1; ReDimNet the inverse of torch_compat's
    (stage<s>_<i>[_conv_block|_<j>] -> stage<s>.<i>[.conv_block|.<j>],
    inputs_weights_<i> -> inputs_weights.<i>, stem_/mfa_/dwconvs_/
    red_dim_conv_/tcm_<i> -> .<i>, feed_forward_* -> feed_forward.*,
    downsample_conv / downsample_bn -> downsample.0 / .1), plus the frozen
    all-ones backbone.inputs_weights.0 that the flax tree does not keep,
    and the 'gru' block's flax GRUCell leaves (fwd / bwd: ir, iz, in, hr,
    hz, hn) packed into upstream's nn.GRU tensors (`pack_gru_keys`; back
    with `expand_gru_keys`, torch_compat's split)

The neural frontends keep the names that torch_compat maps to: HF's
WavLMModel (WavLM: conv_layers_<i>_conv -> feature_extractor.conv_layers.
<i>.conv, layers_<i> -> encoder.layers.<i>, pos_conv_embed_conv ->
encoder.pos_conv_embed.conv, ...), HF's Wav2Vec2BertModel
(Wav2Vec2Bert), the reference whisper encoder (WhisperEncoder:
blocks_<i> -> blocks.<i>, mlp_<i> -> mlp.<i>), whisper_PMFA (bn_norm ->
bn.norm) and W2VBert_Adapter_MFA (adapter_layers_<i> ->
adapter_layers.<i>); an nn.Embed's `embedding` is its (rows, features)
`weight`, untransposed both ways. A composite (models/with_frontend.py)
is named "<frontend family>+<speaker model>" (`rules_name`): its
`frontend` and `speaker_model` subtrees each take their own rules, under
those prefixes, both ways.

`from_jax_dino_state` maps the JAX package's DINO state (its fields as
nested dicts of arrays, as flax.serialization.to_state_dict gives them)
onto the port's student and teacher (ssl/dino.py's DINOModel): the
backbone by the model's rules under `backbone.`, the head under `head.`
(mlp_<i> and mlp_bn_<i> keep their names; last_layer_v, (in, out) in both,
is no `kernel` and keeps its layout), and the center.

`to_jax_variables` is the exact inverse of `from_jax_variables`, the
counterpart of torch_compat.torch_to_flax_variables: the names by the
inverse of the model's rules (`INVERSE_RULES`), each weight of rank 2 to 4
back to its kernel layout, a weight of rank 1 to a norm's `scale`, the
running statistics to `batch_stats`; `num_batches_tracked` and ReDimNet's frozen
backbone.inputs_weights.0 are dropped, since the flax tree keeps neither.
`from_jax_checkpoint` reads the JAX trainers' checkpoint trees: the
supervised trainer's {"params", "batch_stats", "projection"(,
"projection_batch_stats")} (wespeaker_tpu/bin/train.py), and the DINO
trainer's, whose "params" and "batch_stats" hold the teacher's backbone
beside "student_params" and "student_stats" (bin/train_dino.py). Every
head of models/projections.py crosses: the margin heads' `weight` is
(rows, in) in both packages and keeps its layout, the Linear head's
BatchNorm and Dense take the model's rules (`to_jax_projection` writes
them back).

utils/checkpoint.py::load_checkpoint reads either format into a model.
"""

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "embedding": "weight",
}

# the XI pooling's children (pool.lin1_relu_bn Sequential)
_XI_RULES = (
    (r"\blin1_bn\b", "lin1_relu_bn.2"),
    (r"\blin1\b", "lin1_relu_bn.0"),
)
_ECAPA_RULES = (
    (r"\bblock_(\d+)\b", r"se_res2block.\1"),
    (r"\bconvs_(\d+)\b", r"convs.\1"),
    (r"\bbns_(\d+)\b", r"bns.\1"),
) + _XI_RULES
_RESNET_RULES = (
    (r"\blayer(\d)_(\d+)\b", r"layer\1.\2"),
    (r"\bshortcut_conv\b", "shortcut.0"),
    (r"\bshortcut_bn\b", "shortcut.1"),
)
_RES2_RULES = _RESNET_RULES + (
    (r"\bconvs_(\d+)\b", r"convs.\1"),
    (r"\bbns_(\d+)\b", r"bns.\1"),
)
_REDIM_BLOCK_RULES = (
    (r"\bstem_(\d+)\b", r"stem.\1"),
    (r"\bstage(\d+)_(\d+)_conv_block\b", r"stage\1.\2.conv_block"),
    (r"\bstage(\d+)_(\d+)_(\d+)\b", r"stage\1.\2.\3"),
    (r"\bstage(\d+)_(\d+)\b", r"stage\1.\2"),
    (r"\bdwconvs_(\d+)\b", r"dwconvs.\1"),
    (r"\bred_dim_conv_(\d+)\b", r"red_dim_conv.\1"),
    (r"\btcm_(\d+)\b", r"tcm.\1"),
    (r"\bfeed_forward_intermediate_dense\b",
     "feed_forward.intermediate_dense"),
    (r"\bfeed_forward_output_dense\b", "feed_forward.output_dense"),
    (r"\bdownsample_conv\b", "downsample.0"),
    (r"\bdownsample_bn\b", "downsample.1"),
)

# flax child names -> torch module paths, by model family: the rules of
# wespeaker_tpu/utils/torch_compat.py's MODEL_RULES
MODEL_RULES = {
    "ECAPA_TDNN": _ECAPA_RULES,
    "XI_VEC_ECAPA_TDNN": _ECAPA_RULES,
    "XI_VEC": _XI_RULES,
    "XVEC": _XI_RULES,
    "CAMPPlus": (
        (r"\blayer(\d)_(\d+)\b", r"layer\1.\2"),
        (r"\bshortcut_conv\b", "shortcut.0"),
        (r"\bshortcut_bn\b", "shortcut.1"),
        (r"\bout_nonlinear_bn\b", "out_nonlinear.batchnorm"),
        (r"\bnonlinear(\d?)_bn\b", r"nonlinear\1.batchnorm"),
    ),
    "Gemini": (
        (r"\bdownsample_layers_(\d+)_(\d+)\b", r"downsample_layers.\1.\2"),
        (r"\bstages_(\d+)_(\d+)\b", r"stages.\1.\2"),
    ),
    "ResNet": _RESNET_RULES,
    "ERes2Net": _RES2_RULES + (
        (r"\bfuse_models_(\d+)\b", r"fuse_models.\1"),
        (r"\blocal_att_(\d+)\b", r"local_att.\1"),
    ),
    "Res2Net": _RES2_RULES,
    "SimAM_ResNet": (
        (r"\blayer(\d)_(\d+)\b", r"layer\1.\2"),
        (r"\bdownsample_conv\b", "downsample.0"),
        (r"\bdownsample_bn\b", "downsample.1"),
    ),
    # keyed by the port's (and upstream's) class name, which the loader
    # passes; torch_compat keys it by the constructors' prefix `REPVGG`
    "RepVGG": (
        (r"\bstage(\d)_(\d+)\b", r"stage\1.\2"),
    ),
    "ReDimNet": (
        (r"\binputs_weights_(\d+)\b", r"inputs_weights.\1"),
        _REDIM_BLOCK_RULES[0],
        (r"\bmfa_(\d+)\b", r"mfa.\1"),
    ) + _REDIM_BLOCK_RULES[1:],
    "ReDimNet2": (
        (r"\bstage(\d+)_0_w\b", r"stage\1.0.w"),
        (r"\bfin_wght1d_w\b", "fin_wght1d.w"),
    ) + _REDIM_BLOCK_RULES,
    # the neural frontends' heads and encoders; an embedding's flax leaf
    # `embedding` is its torch `weight` (_LEAF_TO_TORCH), kept (rows,
    # features) in both
    "W2VBert_Adapter_MFA": (
        (r"\badapter_layers_(\d+)\b", r"adapter_layers.\1"),
    ),
    "whisper_PMFA": (
        (r"\bbn_norm\b", "bn.norm"),
    ),
    # HF Wav2Vec2BertModel's names
    "Wav2Vec2Bert": (
        (r"\bfeature_projection_layer_norm\b",
         "feature_projection.layer_norm"),
        (r"\bfeature_projection_projection\b",
         "feature_projection.projection"),
        (r"\blayers_(\d+)\b", r"encoder.layers.\1"),
    ),
    # HF WavLMModel's names (the positional conv's weight norm folded)
    "WavLM": (
        (r"\bconv_layers_(\d+)_conv\b", r"conv_layers.\1.conv"),
        (r"\bconv_layers_(\d+)_layer_norm\b", r"conv_layers.\1.layer_norm"),
        (r"\bfeature_projection_layer_norm\b",
         "feature_projection.layer_norm"),
        (r"\bfeature_projection_projection\b",
         "feature_projection.projection"),
        (r"\bpos_conv_embed_conv\b", "encoder.pos_conv_embed.conv"),
        (r"\bencoder_layer_norm\b", "encoder.layer_norm"),
        (r"\blayers_(\d+)\b", r"encoder.layers.\1"),
    ),
    "WhisperEncoder": (
        (r"\bblocks_(\d+)\b", r"blocks.\1"),
        (r"\bmlp_(\d+)\b", r"mlp.\1"),
    ),
    # feat_stack's frontend: featurizer/weights keeps its names
    "StackedFeat": (),
}
# modules whose 2-D `weight` is an embedding table (flax `embedding`),
# not a dense kernel
_EMBEDDINGS = ("rel_attn_embed", "distance_embedding")
# the composite's children (models/with_frontend.py), each converted by
# its own family's rules: "<frontend family>+<speaker model class>"
COMPOSITE_PARTS = ("frontend", "speaker_model")
# the frontend classes' rule families
FRONTEND_FAMILY = {"WavLMWithFeaturizer": "WavLM",
                   "WhisperEncoderFrontend": "WhisperEncoder",
                   "W2VBertFrontend": "Wav2Vec2Bert",
                   "StackedFeatFrontend": "StackedFeat"}
# pooling children of every family: torch_compat's COMMON_RULES (MHASTP's
# heads, MQMHASTP's queries) and ASP's `attention` Sequential, which the
# JAX package maps only under SimAM_ResNet and W2VBert
COMMON_RULES = (
    (r"\bheads_att_trans_(\d+)\b", r"heads_att_trans.\1"),
    (r"\bn_query_(\d+)\b", r"n_query.\1"),
    (r"\batt_conv1\b", "attention.0"),
    (r"\batt_bn\b", "attention.2"),
    (r"\batt_conv2\b", "attention.3"),
)


_GROUP = re.compile(r"\((\\d[+?]?)\)")


def _inverse(rules):
    """The torch -> flax rules of flax -> torch ones, in the same order:
    each replacement becomes a pattern (its \\N the Nth group of the
    rule's pattern) and each pattern's text the replacement."""
    out = []
    for pat, repl in rules:
        groups = _GROUP.findall(pat)
        inv = repl.replace(".", r"\.")
        for n, g in enumerate(groups, start=1):
            inv = inv.replace(f"\\{n}", f"({g})")
        count = iter(range(1, len(groups) + 1))
        back = _GROUP.sub(lambda _: f"\\{next(count)}",
                          pat.replace(r"\b", ""))
        out.append((r"\b" + inv + r"\b", back))
    return tuple(out)


# the inverse of MODEL_RULES and COMMON_RULES: torch names -> flax names
INVERSE_RULES = {k: _inverse(v) for k, v in MODEL_RULES.items()}
INVERSE_COMMON = _inverse(COMMON_RULES)

def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _family(model_name: str):
    """The longest `MODEL_RULES` prefix of model_name, or None."""
    return max((p for p in MODEL_RULES if model_name.startswith(p)),
               key=len, default=None)


def rules_name(model: nn.Module) -> str:
    """The name whose rules map `model`'s flax variables: its class name,
    or a composite's (models/with_frontend.py) "<frontend family>+<speaker
    model class>"."""
    if type(model).__name__ != "FrontendSpeakerModel":
        return type(model).__name__
    return (f"{FRONTEND_FAMILY[type(model.frontend).__name__]}+"
            f"{type(model.speaker_model).__name__}")


def rules_for(model_name: str) -> Tuple[Tuple[str, str], ...]:
    """The name rules of the longest `MODEL_RULES` prefix of model_name;
    none for a model without rules."""
    best = _family(model_name)
    return MODEL_RULES[best] if best else ()


def _torch_key(mods, leaf: str, rules) -> str:
    key = ".".join(mods + (_LEAF_TO_TORCH.get(leaf, leaf),))
    for pat, repl in tuple(rules) + COMMON_RULES:
        key = re.sub(pat, repl, key)
    return key


# flax kernel layout -> torch weight layout, by rank: dense (I, O), conv1d
# (K, I, O), conv2d (kh, kw, I, O)
_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
# and back
_WEIGHT_AXES = {n: tuple(np.argsort(p)) for n, p in _KERNEL_AXES.items()}


def from_jax_variables(variables: Mapping[str, Any],
                       model_name: str = "ECAPA_TDNN") -> "OrderedDict":
    """flax {"params", "batch_stats"} tree (nested dicts of numpy or JAX
    arrays) of the model `model_name` -> the port's state_dict of torch
    tensors. A composite's name is "<frontend family>+<speaker model>"
    (`rules_name` of models/with_frontend.py's FrontendSpeakerModel): its
    `frontend` and `speaker_model` subtrees are converted each by its own
    rules, under those prefixes."""
    if "+" in model_name:
        sd = OrderedDict()
        for part, name in zip(COMPOSITE_PARTS, model_name.split("+")):
            tree = {c: (variables.get(c) or {}).get(part, {})
                    for c in ("params", "batch_stats")}
            for key, value in from_jax_variables(tree, name).items():
                sd[f"{part}.{key}"] = value
        return sd
    rules = rules_for(model_name)
    sd = OrderedDict()
    bn_prefixes = []
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            arr = (_numpy(value) if isinstance(value, torch.Tensor)
                   else np.asarray(value, dtype=np.float32))
            if leaf == "kernel":
                arr = arr.transpose(_KERNEL_AXES[arr.ndim])
            key = _torch_key(tuple(mods), leaf, rules)
            sd[key] = torch.tensor(arr)
            if collection == "batch_stats" and leaf == "mean":
                bn_prefixes.append(key[:-len("running_mean")])
    for prefix in bn_prefixes:
        sd[prefix + "num_batches_tracked"] = torch.tensor(0)
    if rules is MODEL_RULES["ReDimNet"]:
        # upstream's frozen all-ones stage-0 input weight, which the flax
        # tree does not keep (torch_compat ignores it)
        sd["backbone.inputs_weights.0"] = torch.ones(1, 1, 1, 1)
    return pack_gru_keys(sd)


_GATES = ("r", "z", "n")
_CELL = re.compile(r"(.*)\.(fwd|bwd)\.ir\.weight$")


def pack_gru_keys(sd: "OrderedDict") -> "OrderedDict":
    """flax GRUCell leaves (`<p>.fwd|bwd.{ir,iz,in,hr,hz,hn}.weight`, the
    i* and hn biases) -> torch nn.GRU's packed `<p>.gru.weight_ih_l0`,
    `weight_hh_l0`, `bias_ih_l0`, `bias_hh_l0` (`_reverse` for bwd), gates
    in torch's order r, z, n. flax's r and z gates have one bias each,
    which goes to bias_ih; their bias_hh rows are 0. The inverse of
    expand_gru_keys up to that fold."""
    cells = [(m.group(1), m.group(2)) for m in map(_CELL.match, sd) if m]
    for prefix, direction in cells:
        base = f"{prefix}.{direction}"
        w = {f"{k}{g}": sd.pop(f"{base}.{k}{g}.weight")
             for k in "ih" for g in _GATES}
        b = {f"i{g}": sd.pop(f"{base}.i{g}.bias") for g in _GATES}
        hn = sd.pop(f"{base}.hn.bias")
        rev = "_reverse" if direction == "bwd" else ""
        out = f"{prefix}.gru."
        sd[f"{out}weight_ih_l0{rev}"] = torch.cat(
            [w[f"i{g}"] for g in _GATES])
        sd[f"{out}weight_hh_l0{rev}"] = torch.cat(
            [w[f"h{g}"] for g in _GATES])
        sd[f"{out}bias_ih_l0{rev}"] = torch.cat([b[f"i{g}"] for g in _GATES])
        sd[f"{out}bias_hh_l0{rev}"] = torch.cat(
            [torch.zeros_like(hn), torch.zeros_like(hn), hn])
    return sd


def expand_gru_keys(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """torch nn.GRU's packed `<p>.gru.*_l0[_reverse]` -> flax GRUCell
    leaves under `<p>.fwd` / `<p>.bwd` in torch's (out, in) layout, as
    torch_compat.expand_torch_gru_keys splits them: b_hr and b_hz fold
    into the ir and iz biases, b_hn is hn's bias (flax's n = tanh(in(x) +
    r * hn(h)) is torch's)."""
    out = dict(sd)
    for key in list(sd):
        m = re.match(r"(.*)\.gru\.weight_ih_l0(_reverse)?$", key)
        if not m:
            continue
        prefix, rev = m.group(1), m.group(2) or ""
        base = f"{prefix}.{'bwd' if rev else 'fwd'}"
        w_ih = out.pop(f"{prefix}.gru.weight_ih_l0{rev}")
        w_hh = out.pop(f"{prefix}.gru.weight_hh_l0{rev}")
        b_ih = out.pop(f"{prefix}.gru.bias_ih_l0{rev}")
        b_hh = out.pop(f"{prefix}.gru.bias_hh_l0{rev}")
        for g, w_i, w_h in zip(_GATES, w_ih.chunk(3), w_hh.chunk(3)):
            out[f"{base}.i{g}.weight"] = w_i
            out[f"{base}.h{g}.weight"] = w_h
        bi, bh = b_ih.chunk(3), b_hh.chunk(3)
        out[f"{base}.ir.bias"] = bi[0] + bh[0]
        out[f"{base}.iz.bias"] = bi[1] + bh[1]
        out[f"{base}.in.bias"] = bi[2]
        out[f"{base}.hn.bias"] = bh[2]
    return out


def _nest(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _numpy(value) -> np.ndarray:
    return value.detach().cpu().to(torch.float32).numpy()


def to_jax_variables(state_dict: Mapping[str, torch.Tensor],
                     model_name: str = "ECAPA_TDNN") -> Dict[str, Any]:
    """The port's state_dict of the model `model_name` -> the flax
    {"params", "batch_stats"} tree of numpy f32 arrays that
    from_jax_variables reads (its exact inverse), a composite's too."""
    if "+" in model_name:
        out = {"params": {}, "batch_stats": {}}
        for part, name in zip(COMPOSITE_PARTS, model_name.split("+")):
            sub = {k[len(part) + 1:]: v for k, v in state_dict.items()
                   if k.startswith(part + ".")}
            for collection, tree in to_jax_variables(sub, name).items():
                if tree:
                    out[collection][part] = tree
        return out
    family = _family(model_name)
    rules = (INVERSE_RULES[family] if family else ()) + INVERSE_COMMON
    out = {"params": {}, "batch_stats": {}}
    for key, value in expand_gru_keys(state_dict).items():
        if key.endswith("num_batches_tracked") or (
                family == "ReDimNet" and key == "backbone.inputs_weights.0"):
            continue
        for pat, repl in rules:
            key = re.sub(pat, repl, key)
        *mods, leaf = key.split(".")
        arr = _numpy(value)
        collection = "params"
        if leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and mods and mods[-1] in _EMBEDDINGS:
            leaf = "embedding"
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", arr.transpose(_WEIGHT_AXES[arr.ndim])
        _nest(out[collection], tuple(mods) + (leaf,),
              np.ascontiguousarray(arr))
    return out


def to_jax_projection(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The head's state_dict -> {"projection"(, "projection_batch_stats")}
    as the JAX trainer saves it. The margin heads' own tensors (`weight`
    (rows, in), SphereFace2's `bias` (1, 1)) keep their names and layouts
    in both packages; a submodule's (the Linear head's `trans_bn`,
    `trans_linear`) take flax's: a norm's weight is its `scale`, a dense
    weight its (in, out) `kernel`, running statistics `batch_stats`. The
    inverse of from_jax_checkpoint's head."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        *mods, leaf = key.split(".")
        arr = _numpy(value)
        if leaf in ("running_mean", "running_var"):
            _nest(stats, tuple(mods) + (leaf[len("running_"):],), arr)
            continue
        if mods and leaf == "weight":
            leaf, arr = (("scale", arr) if arr.ndim == 1 else
                         ("kernel", arr.transpose(_WEIGHT_AXES[arr.ndim])))
        _nest(params, tuple(mods) + (leaf,), np.ascontiguousarray(arr))
    out = {"projection": params}
    if stats:
        out["projection_batch_stats"] = stats
    return out


def from_jax_checkpoint(tree: Mapping[str, Any], model_name: str
                        ) -> Tuple["OrderedDict", Any]:
    """A JAX trainer's checkpoint tree -> (the model's state_dict, the
    margin head's state_dict or None). The supervised layout holds
    "projection" (and "projection_batch_stats" for a head with BN); the
    DINO layout's "params"/"batch_stats" are the teacher's backbone and
    its student fields are not read."""
    if "params" not in tree:
        raise KeyError(f"no 'params' in the checkpoint: {sorted(tree)}")
    model = from_jax_variables({"params": tree["params"],
                                "batch_stats": tree.get("batch_stats") or {}},
                               model_name)
    projection = None
    if "projection" in tree:
        projection = from_jax_variables(
            {"params": tree["projection"],
             "batch_stats": tree.get("projection_batch_stats") or {}}, "")
    return model, projection


def from_jax_dino_state(state: Mapping[str, Any],
                        model_name: str = "ECAPA_TDNN") -> Dict[str, Any]:
    """The JAX package's DINOState fields {"student", "teacher",
    "student_stats", "teacher_stats", "center", "step"} (nested dicts of
    numpy or JAX arrays; the trees {"backbone", "head"}) -> {"student":
    state_dict, "teacher": state_dict, "center": (1, out_dim) f32 tensor,
    "step": int} for ssl/dino.py's DINOModel with a `model_name`
    backbone."""
    out = {}
    for role in ("student", "teacher"):
        sd = OrderedDict()
        for part, name in (("backbone", model_name), ("head", "DINOHead")):
            tree = {"params": state[role][part],
                    "batch_stats": state[f"{role}_stats"].get(part) or {}}
            for key, value in from_jax_variables(tree, name).items():
                sd[f"{part}.{key}"] = value
        out[role] = sd
    out["center"] = torch.tensor(np.asarray(state["center"], np.float32))
    out["step"] = int(np.asarray(state.get("step", 0)))
    return out


def _unwrap(obj: Any) -> Dict[str, torch.Tensor]:
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()
    for key in ("state_dict", "model"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            obj = obj[key]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
