"""torch.export -> ONNX converter with dynamic batch and time.

Counterpart of wespeaker_tpu/export/jaxpr_to_onnx.py + onnx_ops.py,
written the PyTorch way. The contract is the reference's
(wespeaker/bin/export_onnx.py:92-99): input `feats` (B, T, F) float32,
output `embs` (B, D), B and T dynamic, opset 14, and an optional mean
subtracted inside the graph.

1. A copy of the model is traced by `torch.export.export` on the CPU in
   f32, in eval and on the plain route (`plain_route`: every kernel
   off, ECAPA's Res2 chain too, and plain pooling; the kernels' custom
   ops have no ONNX form), with B and T dynamic. They are `Dim.AUTO`,
   not named `Dim`s: a named Dim fails
   the export on guards its solver cannot prove for every T (CAM++'s
   pad to a segment multiple, ReDimNet2's T // 4 reshapes), which AUTO
   keeps as run-time assertions. The trace must keep both symbolic; a
   model that specialises one raises ConversionError.
2. `run_decompositions()` lowers the graph to core ATen.
3. Each ATen node goes through one handler (`HANDLERS`). Symbolic sizes
   are graph values: `sym_size` becomes Shape + Gather on the tensor, and
   the integer arithmetic on sizes (add, sub, mul, floor division, neg)
   becomes int64 ONNX arithmetic, so the artifact computes its reshape,
   expand, slice and pad extents from the input at run time. The JAX
   converter instead fits closed forms to probes at sampled shapes.
4. A node without a handler raises ConversionError naming its op;
   nothing is skipped but the export's own assertions
   (`_assert_tensor_metadata`, `_assert_scalar`, range constraints),
   which compute nothing.

export/onnx_numpy.py executes the emitted op subset, so a model is
checked without the `onnx` package (neither machine has it).
"""

import copy
import inspect
import operator
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from wespeaker_tpu_torch.export import onnx_proto as op

aten = torch.ops.aten
INT64_MAX = 2 ** 63 - 1

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.float16: np.float16, torch.int64: np.int64,
       torch.int32: np.int32, torch.bool: np.bool_, torch.uint8: np.uint8,
       torch.int8: np.int8}

# the export's own checks: no value, nothing to emit
_ASSERTIONS = {aten._assert_tensor_metadata.default,
               aten._assert_scalar.default,
               aten.sym_constrain_range_for_size.default,
               aten._assert_async.msg}


class ConversionError(RuntimeError):
    pass


class _Embed(nn.Module):
    """feats -> model(feats) [- mean]: the exported function."""

    def __init__(self, model: nn.Module, mean: Optional[torch.Tensor]):
        super().__init__()
        self.model = model
        self.register_buffer("mean", mean)

    def forward(self, feats):
        emb = self.model(feats)
        return emb if self.mean is None else emb - self.mean


def plain_route(model: nn.Module) -> nn.Module:
    """`model` set to eval on the plain torch route: no fused block, chain,
    tail or stage calls and plain pooling (in place; returns it). Every
    submodule with a `set_fused` is reached, and ECAPA's Res2 chain kernel
    is turned off with its blocks, so no kernel's custom op can reach the
    converter."""
    from wespeaker_tpu_torch.models.pooling_layers import set_pooling_fused

    model.eval()
    for m in model.modules():
        if not hasattr(m, "set_fused"):
            continue
        if "fused_res2" in inspect.signature(m.set_fused).parameters:
            m.set_fused(False, fused_res2=False)
        else:
            m.set_fused(False)
    return set_pooling_fused(model, False)


def export_program(model: nn.Module, feat_dim: int,
                   mean_vec: Optional[np.ndarray] = None,
                   example_frames: int = 200,
                   plain: bool = True) -> torch.export.ExportedProgram:
    """torch.export of feats (B, T, feat_dim) f32 -> embeddings [- mean]
    on the CPU, B and T dynamic. `plain` puts a copy of the model on the
    plain route; otherwise the copy keeps its routes (a .pt2 that runs the
    kernels' custom ops on the card)."""
    from torch.export import Dim
    from torch.fx.experimental.symbolic_shapes import is_concrete_int

    model = copy.deepcopy(model).cpu().float().eval()
    if plain:
        plain_route(model)
    mean = (None if mean_vec is None
            else torch.as_tensor(np.asarray(mean_vec, np.float32)))
    example = torch.zeros(2, example_frames, feat_dim)
    with torch.no_grad():
        ep = torch.export.export(
            _Embed(model, mean), (example,),
            dynamic_shapes={"feats": {0: Dim.AUTO, 1: Dim.AUTO}})
    shape = [n for n in ep.graph.nodes if n.op == "placeholder"
             and n.name == _user_input(ep)][0].meta["val"].shape
    static = [name for name, d in zip("BT", shape[:2])
              if is_concrete_int(d)]
    if static:
        raise ConversionError(
            f"the trace specialised {', '.join(static)} to "
            f"{[int(shape[i]) for i in range(2)]}: the model branches on it "
            "or reads it as a Python number")
    return ep


def _user_input(ep) -> str:
    from torch.export.graph_signature import InputKind

    names = [s.arg.name for s in ep.graph_signature.input_specs
             if s.kind == InputKind.USER_INPUT]
    if len(names) != 1:
        raise ConversionError(f"want one input, got {names}")
    return names[0]


class _Builder:
    """Collects ONNX nodes and initializers under unique names."""

    def __init__(self):
        self.nodes: List[op.Node] = []
        self.inits: List[op.Tensor] = []
        self._consts: Dict[tuple, str] = {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op_type: str, inputs: Sequence[str], attrs=None) -> str:
        out = self.fresh(op_type.lower())
        self.nodes.append(op.Node(op_type, list(inputs), [out],
                                  dict(attrs or {})))
        return out

    def const(self, value, dtype) -> str:
        arr = np.asarray(value, dtype=dtype)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key not in self._consts:
            name = self.fresh("const")
            self.inits.append(op.Tensor(name, arr))
            self._consts[key] = name
        return self._consts[key]

    def initializer(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint.replace(".", "_"))
        self.inits.append(op.Tensor(name, np.ascontiguousarray(arr)))
        return name


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _dtype(node) -> torch.dtype:
    v = _val(node)
    if not isinstance(v, torch.Tensor):
        raise ConversionError(f"{node} is not a tensor")
    return v.dtype


class _Converter:
    def __init__(self, ep, input_name: str):
        from torch.export.graph_signature import InputKind

        self.b = _Builder()
        self.env: Dict[torch.fx.Node, object] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        user = _user_input(ep)
        for spec in ep.graph_signature.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                continue
            if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
                t = ep.state_dict.get(spec.target)
                if t is None:  # a non-persistent buffer
                    t = ep.constants[spec.target]
            elif spec.kind == InputKind.CONSTANT_TENSOR:
                t = ep.constants[spec.target]
            else:
                raise ConversionError(f"input kind {spec.kind} of "
                                      f"{spec.arg.name}")
            self.arrays[spec.arg.name] = (t.detach().cpu().numpy()
                                          if t is not None else None)
        self.user, self.input_name = user, input_name

    # ---- values ----

    def value(self, arg) -> str:
        """The ONNX name of an fx node's (single) value; parameters become
        initializers at their first use."""
        if not isinstance(arg, torch.fx.Node):
            raise ConversionError(f"expected a graph value, got {arg!r}")
        if arg not in self.env:
            if arg.op == "placeholder" and arg.name in self.arrays:
                self.env[arg] = self.b.initializer(arg.name,
                                                   self.arrays[arg.name])
            else:
                raise ConversionError(f"{arg} has no value yet")
        v = self.env[arg]
        if isinstance(v, tuple):
            raise ConversionError(f"{arg} has several outputs")
        return v

    def operand(self, arg, dtype: torch.dtype) -> str:
        """A tensor operand in `dtype`: a graph tensor (cast if its type
        differs), a symbolic size (cast), or a Python scalar (constant)."""
        if isinstance(arg, torch.fx.Node):
            v = _val(arg)
            name = self.value(arg)
            have = v.dtype if isinstance(v, torch.Tensor) else torch.int64
            if have != dtype:
                name = self.b.add("Cast", [name],
                                  {"to": op.NP_TO_ONNX[np.dtype(_NP[dtype])]})
            return name
        if isinstance(arg, (bool, int, float)):
            return self.b.const(arg, _NP[dtype])
        raise ConversionError(f"operand {arg!r}")

    def int_scalar(self, arg) -> str:
        """A 0-d int64: a symbolic size's value or a constant."""
        if isinstance(arg, torch.fx.Node):
            return self.operand(arg, torch.int64)
        return self.b.const(int(arg), np.int64)

    def int_list(self, items) -> str:
        """A 1-D int64 of static ints and symbolic sizes."""
        items = list(items)
        if all(not isinstance(x, torch.fx.Node) for x in items):
            return self.b.const(np.asarray(items, np.int64).reshape(-1),
                                np.int64)
        axis0 = self.b.const([0], np.int64)
        parts = [self.b.add("Unsqueeze", [self.int_scalar(x), axis0])
                 for x in items]
        return self.b.add("Concat", parts, {"axis": 0})

    # ---- the graph ----

    def run(self, ep, output_name: str) -> op.Graph:
        out_node = None
        for node in ep.graph.nodes:
            if node.op == "placeholder":
                if node.name == self.user:
                    self.env[node] = self.input_name
            elif node.op == "call_function":
                if node.target in _ASSERTIONS:
                    continue
                handler = HANDLERS.get(node.target)
                if handler is None:
                    raise ConversionError(
                        f"no ONNX handler for {node.target} ({node.name})")
                self.env[node] = handler(self, node, *node.args,
                                         **node.kwargs)
            elif node.op == "output":
                outs = node.args[0]
                if len(outs) != 1:
                    raise ConversionError(f"want one output, got {outs}")
                out_node = outs[0]
            else:
                raise ConversionError(f"graph node kind {node.op}")
        self.b.nodes.append(op.Node("Identity", [self.value(out_node)],
                                    [output_name]))
        feat_dim = int(_val([n for n in ep.graph.nodes
                             if n.name == self.user][0]).shape[2])
        emb_dim = int(_val(out_node).shape[1])
        return op.Graph(
            "wespeaker_tpu_torch", self.b.nodes,
            [op.ValueInfo(self.input_name, op.FLOAT, ["B", "T", feat_dim])],
            [op.ValueInfo(output_name, op.FLOAT, ["B", emb_dim])],
            self.b.inits)


# ---- handlers: (converter, node, *args, **kwargs) -> ONNX name(s) ----

def _rank(node) -> int:
    return len(_val(node).shape)


def _axis(dim: int, rank: int) -> int:
    return dim % rank if rank else 0


def _binary(onnx_type):
    def handler(c, node, a, b, alpha=1, **_):
        dt = _dtype(node)
        rhs = c.operand(b, dt)
        if alpha != 1:
            rhs = c.b.add("Mul", [rhs, c.b.const(alpha, _NP[dt])])
        return c.b.add(onnx_type, [c.operand(a, dt), rhs])
    return handler


def _unary(onnx_type):
    def handler(c, node, x):
        return c.b.add(onnx_type, [c.value(x)])
    return handler


def _convolution(c, node, x, w, bias, stride, padding, dilation,
                 transposed, output_padding, groups):
    if transposed:
        raise ConversionError("transposed convolution is not emitted")
    ins = [c.value(x), c.value(w)] + ([c.value(bias)] if bias is not None
                                      else [])
    return c.b.add("Conv", ins, {
        "strides": [int(s) for s in stride],
        "pads": [int(p) for p in padding] * 2,
        "dilations": [int(d) for d in dilation], "group": int(groups),
        "kernel_shape": [int(k) for k in _val(w).shape[2:]]})


def _channel_vec(c, v, rank: int) -> str:
    """A (C,) value shaped (C, 1, ...) to broadcast over (N, C, ...)."""
    return c.b.add("Reshape", [c.value(v), c.b.const(
        [-1] + [1] * (rank - 2), np.int64)])


def _batch_norm_eval(c, node, x, w, bias, mean, var, momentum, eps):
    rank = _rank(x)
    dt = _NP[_dtype(x)]
    y = c.b.add("Sub", [c.value(x), _channel_vec(c, mean, rank)])
    std = c.b.add("Sqrt", [c.b.add("Add", [_channel_vec(c, var, rank),
                                            c.b.const(eps, dt)])])
    y = c.b.add("Div", [y, std])
    if w is not None:
        y = c.b.add("Mul", [y, _channel_vec(c, w, rank)])
    if bias is not None:
        y = c.b.add("Add", [y, _channel_vec(c, bias, rank)])
    return (y, None, None)


def _layer_norm(c, node, x, normalized_shape, w=None, bias=None,
                eps=1e-5):
    axes = list(range(-len(normalized_shape), 0))
    dt = _NP[_dtype(x)]
    mean = c.b.add("ReduceMean", [c.value(x)], {"axes": axes,
                                                "keepdims": 1})
    d = c.b.add("Sub", [c.value(x), mean])
    var = c.b.add("ReduceMean", [c.b.add("Mul", [d, d])],
                  {"axes": axes, "keepdims": 1})
    y = c.b.add("Div", [d, c.b.add("Sqrt", [c.b.add(
        "Add", [var, c.b.const(eps, dt)])])])
    if w is not None:
        y = c.b.add("Mul", [y, c.value(w)])
    if bias is not None:
        y = c.b.add("Add", [y, c.value(bias)])
    return (y, None, None)


def _softmax(c, node, x, dim, half_to_float=False):
    if half_to_float:
        raise ConversionError("half_to_float softmax")
    axis = _axis(dim, _rank(x))
    xv = c.value(x)
    m = c.b.add("ReduceMax", [xv], {"axes": [axis], "keepdims": 1})
    e = c.b.add("Exp", [c.b.add("Sub", [xv, m])])
    s = c.b.add("ReduceSum", [e, c.b.const([axis], np.int64)],
                {"keepdims": 1})
    return c.b.add("Div", [e, s])


def _addmm(c, node, bias, m1, m2, beta=1, alpha=1):
    dt = _dtype(node)
    prod = c.b.add("MatMul", [c.value(m1), c.value(m2)])
    if alpha != 1:
        prod = c.b.add("Mul", [prod, c.b.const(alpha, _NP[dt])])
    bv = c.operand(bias, dt)
    if beta != 1:
        bv = c.b.add("Mul", [bv, c.b.const(beta, _NP[dt])])
    return c.b.add("Add", [prod, bv])


def _matmul(c, node, a, b):
    return c.b.add("MatMul", [c.value(a), c.value(b)])


def _cat(c, node, tensors, dim=0):
    dt = _dtype(node)
    return c.b.add("Concat", [c.operand(t, dt) for t in tensors],
                   {"axis": _axis(dim, _rank(node))})


def _clamp(c, node, x, min=None, max=None):
    dt = _NP[_dtype(node)]
    y = c.value(x)
    if min is not None:
        y = c.b.add("Max", [y, c.b.const(min, dt)])
    if max is not None:
        y = c.b.add("Min", [y, c.b.const(max, dt)])
    return y


def _identity(c, node, x, **_):
    return c.b.add("Identity", [c.value(x)])


def _full(c, node, size, fill_value, **_):
    dt = _dtype(node)
    if not any(isinstance(v, torch.fx.Node) for v in list(size)
               + [fill_value]):
        return c.b.const(np.full(size, fill_value), _NP[dt])
    fill = c.operand(fill_value, dt)
    if len(size) == 0:
        return fill
    return c.b.add("Expand", [fill, c.int_list(size)])


def _reduce(onnx_type):
    def handler(c, node, x, dims=None, keepdim=False, dtype=None):
        rank = _rank(x)
        axes = (list(range(rank)) if not dims
                else [_axis(d, rank) for d in dims])
        if onnx_type == "ReduceSum":
            return c.b.add("ReduceSum", [c.value(x), c.b.const(
                axes, np.int64)], {"keepdims": int(keepdim)})
        return c.b.add(onnx_type, [c.value(x)],
                       {"axes": axes, "keepdims": int(keepdim)})
    return handler


def _permute(c, node, x, dims):
    rank = _rank(x)
    return c.b.add("Transpose", [c.value(x)],
                   {"perm": [_axis(d, rank) for d in dims]})


def _pow_scalar(c, node, x, exponent):
    xv = c.value(x)
    if exponent == 2:
        return c.b.add("Mul", [xv, xv])
    if exponent == 0.5:
        return c.b.add("Sqrt", [xv])
    return c.b.add("Pow", [xv, c.b.const(exponent, _NP[_dtype(node)])])


def _relu(c, node, x):
    return c.b.add("Max", [c.value(x), c.b.const(0, _NP[_dtype(node)])])


def _select(c, node, x, dim, index):
    return c.b.add("Gather", [c.value(x), c.int_scalar(index)],
                   {"axis": _axis(dim, _rank(x))})


def _slice(c, node, x, dim=0, start=None, end=None, step=1):
    return c.b.add("Slice", [
        c.value(x), c.int_list([0 if start is None else start]),
        c.int_list([INT64_MAX if end is None else end]),
        c.b.const([_axis(dim, _rank(x))], np.int64), c.int_list([step])])


def _squeeze(c, node, x, dims):
    shape = _val(x).shape
    rank = len(shape)
    axes = []
    for d in dims:
        size = shape[_axis(d, rank)]
        if isinstance(size, torch.SymInt):
            raise ConversionError(f"squeeze of the symbolic dim {d} of "
                                  f"{x.name}")
        if size == 1:  # torch leaves any other size alone
            axes.append(_axis(d, rank))
    if not axes:
        return c.b.add("Identity", [c.value(x)])
    return c.b.add("Squeeze", [c.value(x), c.b.const(axes, np.int64)])


def _unsqueeze(c, node, x, dim):
    return c.b.add("Unsqueeze", [c.value(x), c.b.const(
        [_axis(dim, _rank(node))], np.int64)])


def _view(c, node, x, size):
    return c.b.add("Reshape", [c.value(x), c.int_list(size)])


def _expand(c, node, x, size, implicit=False):
    # torch's -1 keeps a dim; ONNX's Expand broadcasts both ways, so 1
    return c.b.add("Expand", [c.value(x), c.int_list(
        [1 if (not isinstance(s, torch.fx.Node) and s == -1) else s
         for s in size])])


def _constant_pad(c, node, x, pad, value=0):
    rank = _rank(x)
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        begins[rank - 1 - i] = pad[2 * i]
        ends[rank - 1 - i] = pad[2 * i + 1]
    return c.b.add("Pad", [c.value(x), c.int_list(begins + ends),
                           c.b.const(value, _NP[_dtype(x)])])


def _gelu(c, node, x, approximate="none"):
    dt = _NP[_dtype(x)]
    xv = c.value(x)
    half = c.b.add("Mul", [xv, c.b.const(0.5, dt)])
    if approximate == "tanh":
        cube = c.b.add("Mul", [c.b.add("Mul", [xv, xv]), xv])
        inner = c.b.add("Mul", [c.b.add("Add", [xv, c.b.add(
            "Mul", [cube, c.b.const(0.044715, dt)])]), c.b.const(
            np.sqrt(2.0 / np.pi), dt)])
        t = c.b.add("Tanh", [inner])
    else:
        t = c.b.add("Erf", [c.b.add("Mul", [xv, c.b.const(
            1.0 / np.sqrt(2.0), dt)])])
    return c.b.add("Mul", [half, c.b.add("Add", [t, c.b.const(1.0, dt)])])


def _sym_size(c, node, x, dim):
    shape = c.b.add("Shape", [c.value(x)])
    return c.b.add("Gather", [shape, c.b.const(_axis(dim, _rank(x)),
                                               np.int64)])


def _sym_binary(onnx_type):
    def handler(c, node, a, b):
        return c.b.add(onnx_type, [c.int_scalar(a), c.int_scalar(b)])
    return handler


def _sym_floordiv(c, node, a, b):
    # ONNX's integer Div truncates; (a - a mod b) / b is exact, so floors
    av, bv = c.int_scalar(a), c.int_scalar(b)
    rem = c.b.add("Mod", [av, bv])
    return c.b.add("Div", [c.b.add("Sub", [av, rem]), bv])


def _sym_neg(c, node, a):
    return c.b.add("Neg", [c.int_scalar(a)])


def _getitem(c, node, src, index):
    outs = c.env[src]
    if not isinstance(outs, tuple) or outs[index] is None:
        raise ConversionError(f"output {index} of {src.name} is not "
                              "emitted")
    return outs[index]


HANDLERS = {
    aten.convolution.default: _convolution,
    aten._native_batch_norm_legit_no_training.default: _batch_norm_eval,
    aten.native_layer_norm.default: _layer_norm,
    aten._softmax.default: _softmax,
    aten.add.Tensor: _binary("Add"),
    aten.sub.Tensor: _binary("Sub"),
    aten.mul.Tensor: _binary("Mul"),
    aten.div.Tensor: _binary("Div"),
    aten.addmm.default: _addmm,
    aten.mm.default: _matmul,
    aten.bmm.default: _matmul,
    aten.cat.default: _cat,
    aten.clamp.default: _clamp,
    aten.clone.default: _identity,
    aten.full.default: _full,
    aten.mean.dim: _reduce("ReduceMean"),
    aten.sum.dim_IntList: _reduce("ReduceSum"),
    aten.permute.default: _permute,
    aten.pow.Tensor_Scalar: _pow_scalar,
    aten.relu.default: _relu,
    aten.sigmoid.default: _unary("Sigmoid"),
    aten.tanh.default: _unary("Tanh"),
    aten.sqrt.default: _unary("Sqrt"),
    aten.select.int: _select,
    aten.slice.Tensor: _slice,
    aten.squeeze.dims: _squeeze,
    aten.unsqueeze.default: _unsqueeze,
    aten.view.default: _view,
    aten.expand.default: _expand,
    aten.constant_pad_nd.default: _constant_pad,
    aten.gelu.default: _gelu,
    aten.sym_size.int: _sym_size,
    operator.add: _sym_binary("Add"),
    operator.sub: _sym_binary("Sub"),
    operator.mul: _sym_binary("Mul"),
    operator.floordiv: _sym_floordiv,
    operator.neg: _sym_neg,
    operator.getitem: _getitem,
}


def convert_program(ep, input_name: str = "feats",
                    output_name: str = "embs") -> bytes:
    """An exported program (one input (B, T, F) -> one (B, D)), lowered
    to core ATen, as serialized ONNX."""
    ep = ep.run_decompositions()
    graph = _Converter(ep, input_name).run(ep, output_name)
    return op.encode_model(graph, opset=14)


def convert(model: nn.Module, feat_dim: int,
            mean_vec: Optional[np.ndarray] = None,
            example_frames: int = 200) -> bytes:
    """The model's eval forward, feats (B, T, feat_dim) f32 -> embs (B,
    D) [- mean_vec], as a dynamic-shape ONNX model (serialized bytes)."""
    return convert_program(export_program(model, feat_dim, mean_vec,
                                          example_frames))
