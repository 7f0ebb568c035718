"""Numpy executor for the ONNX op subset that export/fx_to_onnx.py emits.

The port's own copy of wespeaker_tpu/export/onnx_numpy.py, with
ReduceMean and Conv's optional bias input added. Neither machine has
`onnx` or `onnxruntime`, so an exported artifact is checked by decoding
its bytes through the
independent reader (onnx_proto.decode_model) and executing the graph here
per the public ONNX operator specifications (opset 14 semantics for the
ops used): the offline stand-in for the reference's pt<->onnx parity
contract (runtime/onnxruntime/README.md:109-110). Plain numpy on the
host; `chip_smoke.py` and a user on the card's machine run it as it is.
"""

from typing import Dict

import numpy as np

from wespeaker_tpu_torch.export import onnx_proto as op


def _conv_np(x, w, strides, pads, dilations, group):
    """Grouped ND convolution, channels-first (N, C, *sp), via im2col."""
    n, cin, *sp = x.shape
    cout, cin_g, *ks = w.shape
    nsp = len(sp)
    lo, hi = pads[:nsp], pads[nsp:]
    x = np.pad(x, [(0, 0), (0, 0)] + list(zip(lo, hi)))
    sp_pad = x.shape[2:]
    out_sp = [(sp_pad[i] - (ks[i] - 1) * dilations[i] - 1) // strides[i] + 1
              for i in range(nsp)]
    cout_g = cout // group

    # gather input patches: (N, C, *out_sp, *ks)
    idx = []
    for i in range(nsp):
        base = np.arange(out_sp[i]) * strides[i]
        offs = np.arange(ks[i]) * dilations[i]
        idx.append(base[:, None] + offs[None, :])  # (out, k)
    patches = x
    for i in range(nsp):
        patches = np.take(patches, idx[i], axis=2 + 2 * i)
        # axis layout grows: (N, C, out_0, k_0, out_1, k_1, ...)
    # reorder to (N, C, out..., k...)
    perm = [0, 1] + [2 + 2 * i for i in range(nsp)] + \
        [3 + 2 * i for i in range(nsp)]
    patches = patches.transpose(perm)

    out = np.empty([n, cout] + out_sp, x.dtype)
    for g in range(group):
        pg = patches[:, g * cin_g:(g + 1) * cin_g]  # (N, cg, out..., k...)
        wg = w[g * cout_g:(g + 1) * cout_g]         # (cog, cg, k...)
        out[:, g * cout_g:(g + 1) * cout_g] = np.einsum(
            pg, [0, 1] + list(range(2, 2 + nsp))
            + list(range(2 + nsp, 2 + 2 * nsp)),
            wg, [2 + 2 * nsp] + [1] + list(range(2 + nsp, 2 + 2 * nsp)),
            [0, 2 + 2 * nsp] + list(range(2, 2 + nsp)))
    return out


def _slice_np(data, starts, ends, axes=None, steps=None):
    rank = data.ndim
    axes = list(range(rank)) if axes is None else [a % rank for a in axes]
    steps = [1] * len(axes) if steps is None else list(steps)
    sl = [slice(None)] * rank
    for a, s, e, st in zip(axes, starts, ends, steps):
        dim = data.shape[a]
        s, e = int(s), int(e)
        if st > 0:
            s = min(max(s + dim if s < 0 else s, 0), dim)
            e = min(max(e + dim if e < 0 else e, 0), dim)
        else:
            s = min(max(s + dim if s < 0 else s, -1), dim - 1)
            e = max(min(e + dim if e < -dim else e, dim), -dim - 1)
            if e == -dim - 1:
                e = None
        sl[a] = slice(s, e, st)
    return data[tuple(sl)]


def run(model_bytes: bytes, feeds: Dict[str, np.ndarray]):
    """Execute a serialized model; returns {output_name: array}."""
    model = op.decode_model(model_bytes)
    g = model.graph
    env: Dict[str, np.ndarray] = {}
    for t in g.initializers:
        env[t.name] = t.array
    for vi in g.inputs:
        env[vi.name] = np.asarray(feeds[vi.name])

    for node in g.nodes:
        ins = [env[i] for i in node.inputs]
        a = node.attrs
        t = node.op_type
        if t == "Conv":
            out = _conv_np(ins[0], ins[1], a.get("strides"),
                           a.get("pads"), a.get("dilations"),
                           a.get("group", 1))
            if len(ins) > 2:  # the optional bias B, one per out channel
                out = out + ins[2].reshape((-1,) + (1,) * (out.ndim - 2))
        elif t == "MatMul":
            out = np.matmul(ins[0], ins[1])
        elif t == "Einsum":
            out = np.einsum(a["equation"].decode(), *ins)
        elif t == "Add":
            out = ins[0] + ins[1]
        elif t == "Sub":
            out = ins[0] - ins[1]
        elif t == "Mul":
            out = ins[0] * ins[1]
        elif t == "Div":
            if np.issubdtype(ins[0].dtype, np.integer):
                out = ins[0] // ins[1]
            else:
                out = ins[0] / ins[1]
        elif t == "Max":
            out = np.maximum(ins[0], ins[1])
        elif t == "Min":
            out = np.minimum(ins[0], ins[1])
        elif t == "Pow":
            out = np.power(ins[0], ins[1])
        elif t == "Mod":
            out = np.mod(ins[0], ins[1])
        elif t == "Reciprocal":
            out = 1.0 / ins[0]
        elif t == "Sqrt":
            out = np.sqrt(ins[0])
        elif t == "Exp":
            out = np.exp(ins[0])
        elif t == "Log":
            out = np.log(ins[0])
        elif t == "Tanh":
            out = np.tanh(ins[0])
        elif t == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        elif t == "Abs":
            out = np.abs(ins[0])
        elif t == "Neg":
            out = -ins[0]
        elif t == "Erf":
            from scipy.special import erf
            out = erf(ins[0]).astype(ins[0].dtype)
        elif t == "Floor":
            out = np.floor(ins[0])
        elif t == "Ceil":
            out = np.ceil(ins[0])
        elif t == "Sign":
            out = np.sign(ins[0])
        elif t == "Identity":
            out = ins[0]
        elif t == "Where":
            out = np.where(ins[0], ins[1], ins[2])
        elif t == "Cast":
            out = ins[0].astype(op.ONNX_TO_NP[a["to"]])
        elif t == "ReduceSum":
            axes = tuple(int(x) for x in ins[1]) if len(ins) > 1 else None
            out = np.sum(ins[0], axis=axes,
                         keepdims=bool(a.get("keepdims", 1)))
        elif t == "ReduceMean":
            axes = tuple(a["axes"]) if "axes" in a else None
            out = np.mean(ins[0], axis=axes,
                          keepdims=bool(a.get("keepdims", 1)))
        elif t == "ReduceMax":
            axes = tuple(a["axes"]) if "axes" in a else None
            out = np.max(ins[0], axis=axes,
                         keepdims=bool(a.get("keepdims", 1)))
        elif t == "ReduceMin":
            axes = tuple(a["axes"]) if "axes" in a else None
            out = np.min(ins[0], axis=axes,
                         keepdims=bool(a.get("keepdims", 1)))
        elif t == "Concat":
            out = np.concatenate(ins, axis=a["axis"])
        elif t == "Reshape":
            shape = [int(x) for x in ins[1]]
            out = ins[0].reshape(shape)
        elif t == "Expand":
            shape = [int(x) for x in ins[1]]
            out = np.broadcast_to(
                ins[0], np.broadcast_shapes(ins[0].shape, tuple(shape)))
        elif t == "Squeeze":
            axes = tuple(int(x) for x in ins[1])
            out = np.squeeze(ins[0], axis=axes)
        elif t == "Unsqueeze":
            out = ins[0]
            for ax in sorted(int(x) for x in ins[1]):
                out = np.expand_dims(out, ax)
        elif t == "Transpose":
            out = np.transpose(ins[0], a["perm"])
        elif t == "Pad":
            rank = ins[0].ndim
            pads = [int(x) for x in ins[1]]
            cval = ins[2] if len(ins) > 2 else 0.0
            out = np.pad(ins[0],
                         list(zip(pads[:rank], pads[rank:])),
                         constant_values=cval)
        elif t == "Shape":
            out = np.asarray(ins[0].shape, np.int64)
        elif t == "Gather":
            out = np.take(ins[0], ins[1].astype(np.int64),
                          axis=a.get("axis", 0))
        elif t == "Slice":
            out = _slice_np(ins[0], ins[1], ins[2],
                            ins[3] if len(ins) > 3 else None,
                            ins[4] if len(ins) > 4 else None)
        else:
            raise NotImplementedError(f"op {t}")
        for name in node.outputs:
            env[name] = out

    return {vi.name: env[vi.name] for vi in g.outputs}
