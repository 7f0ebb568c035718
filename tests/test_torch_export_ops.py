"""The eval kernels of rows 3, 6, 7, 8 and 9 as custom ops, and the `.pt2`
of each family whose eval route holds one, on the CPU against the JAX
package.

- Each op (`wespeaker_tpu_torch::fused_res2_chain`, `::fused_softmax_stats`,
  `::fused_masked_stats`, `::fused_cam_dense_block`,
  `::fused_inv_bottleneck_stage`) at a small shape, with and without a
  mask where it takes one: its CPU implementation equals its plain twin
  bit for bit, its fake gives the real output's shape, dtype and strides
  (the Gemini stage's channels-last view included, at a map with a
  dimension of 1 too), and `torch.library.opcheck` passes. With gradients
  wanted on the CPU the wrappers stay differentiable.
- A `.pt2` of CAM++, Gemini, ResNet34, ReDimNet and ECAPA c512 on its
  `fused_res2` route, narrow and shallow (tests/torch_export_util.py),
  with weights from the JAX package: it holds one op node a kernel call,
  in the counts of eager's route; loaded back by `load_exported(...,
  "cpu")` at (B, T) = (3, 77) and (1, 137) it equals eager to the bit,
  and JAX's `model.apply` within 1e-4 of the largest magnitude. CAM++ is
  built at growth 32 and bottleneck 128 (the kernel route's shapes) with
  one layer a block; ECAPA at 512 channels (the kernel route's width), its
  JAX twin on the plain route (the same function).
- The ONNX export of that ECAPA reaches no custom op (`plain_route` turns
  the Res2 chain off too) and matches JAX.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from tests import torch_export_util as teu  # noqa: E402
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu.models import campplus as jcam  # noqa: E402
from wespeaker_tpu.models import ecapa_tdnn as jecapa  # noqa: E402
from wespeaker_tpu_torch.bin import export_model  # noqa: E402
from wespeaker_tpu_torch.export import fx_to_onnx  # noqa: E402
from wespeaker_tpu_torch.export import onnx_numpy, onnx_proto  # noqa: E402
from wespeaker_tpu_torch.models import ecapa_tdnn  # noqa: E402
from wespeaker_tpu_torch.ops import (cam_block, inv_bottleneck,  # noqa: E402
                                     pooling, res2_chain)
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)

OPS = torch.ops.wespeaker_tpu_torch
SHAPES = ((3, 77), (1, 137))


def _t(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _mask(b, t):
    m = torch.ones(b, t)
    m[-1, t // 2:] = 0
    return m


def _case(name, masked):
    """(op, its arguments, the plain twin's output) at a small shape."""
    rng = np.random.default_rng(len(name) + masked)
    if name == "masked_stats":
        x = _t(rng, 2, 9, 24)
        m = _mask(2, 9) if masked else None
        return (OPS.fused_masked_stats, (x, m, 1),
                torch.cat(pooling.masked_stats_reference(x, m, 1), -1))
    if name == "softmax_stats":
        logits, x = _t(rng, 2, 9, 24), _t(rng, 2, 9, 24)
        m = _mask(2, 9) if masked else None
        return (OPS.fused_softmax_stats, (logits, x, m),
                torch.cat(pooling.softmax_stats_reference(logits, x, m), -1))
    if name == "res2_chain":
        x = _t(rng, 2, 9, 32)
        w = (_t(rng, 3, 3, 8, 8) / 5, _t(rng, 3, 8), 1 + _t(rng, 3, 8) / 10,
             _t(rng, 3, 8))
        return (OPS.fused_res2_chain, (x, *w, 2),
                res2_chain.res2_chain_reference(x, *w, 2))
    if name == "cam_dense_block":
        layers, c0, g, k = 2, 32, cam_block.GROWTH, cam_block.BOTTLENECK
        cend = c0 + g * layers
        x = _t(rng, 2, 9, c0)
        w = (1 + _t(rng, layers, cend) / 10, _t(rng, layers, cend),
             _t(rng, layers, cend, k) / 10, 1 + _t(rng, layers, k) / 10,
             _t(rng, layers, k), _t(rng, layers, 3, k, g) / 20,
             _t(rng, layers, k, k // 2) / 10, _t(rng, layers, k // 2),
             _t(rng, layers, k // 2, g) / 8, _t(rng, layers, g))
        m = _mask(2, 9) if masked else None
        return (OPS.fused_cam_dense_block, (x, *w, 2, 4, m),
                cam_block.cam_dense_block_reference(x, *w, 2, 4, m))
    # the Gemini stage; "masked" picks a map with B = F = 1 instead (the
    # op takes no mask): channels-last is ambiguous there
    b, f = (1, 1) if masked else (2, 4)
    c, layers = 8, 2
    x = _t(rng, b, f, 5, c).permute(0, 3, 1, 2)
    w = (_t(rng, layers, c, 4 * c) / 3, 1 + _t(rng, layers, 4 * c) / 10,
         _t(rng, layers, 4 * c), _t(rng, layers, 3, 3, 4 * c) / 3,
         1 + _t(rng, layers, 4 * c) / 10, _t(rng, layers, 4 * c),
         _t(rng, layers, 4 * c, c) / 6, 1 + _t(rng, layers, c) / 10,
         _t(rng, layers, c))
    return (OPS.fused_inv_bottleneck_stage, (x, *w),
            inv_bottleneck.inv_bottleneck_stage_reference(x, *w))


CASES = [(n, m) for n in ("masked_stats", "softmax_stats", "cam_dense_block",
                          "inv_bottleneck_stage") for m in (False, True)]
CASES.insert(4, ("res2_chain", False))


@pytest.mark.parametrize("name,masked", CASES)
def test_each_op_is_its_plain_twin_with_a_faithful_fake(name, masked):
    op, args, want = _case(name, masked)
    got = op(*args)
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args])
    assert (fake.shape, fake.dtype, fake.stride()) == (
        got.shape, got.dtype, got.stride()), name
    if name == "inv_bottleneck_stage":
        b, c, f, t = got.shape
        assert got.stride() == (f * t * c, 1, t * c, c)
    torch.library.opcheck(op, args)


def test_the_wrappers_stay_differentiable_on_the_cpu():
    """With gradients wanted, a CPU call runs the plain twin (the ops have
    no autograd formula) and keeps the wrappers' outputs."""
    for name in ("masked_stats", "res2_chain", "cam_dense_block",
                 "inv_bottleneck_stage"):
        _, args, want = _case(name, False)
        x = args[0].clone().requires_grad_()
        if name == "masked_stats":
            out = pooling.fused_masked_stats(x, None, 1, concat=True)
        elif name == "res2_chain":
            out = res2_chain.fused_res2_chain(x, *args[1:5], dilation=2)
        elif name == "cam_dense_block":
            out = cam_block.fused_cam_dense_block(x, *args[1:11], dilation=2,
                                                  seg_len=4)
        else:
            out = inv_bottleneck.fused_inv_bottleneck_stage(x, *args[1:])
        assert torch.equal(out.detach(), want)
        out.square().sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()
    _, (lg, x, m), want = _case("softmax_stats", True)
    lg = lg.clone().requires_grad_()
    mean, std = pooling.fused_softmax_stats(lg, x, m)
    assert torch.equal(torch.cat([mean, std], -1).detach(), want)
    (mean.sum() + std.sum()).backward()
    assert torch.isfinite(lg.grad).all()


# --- the families' .pt2 ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ecapa_res2():
    """ECAPA at 512 channels (the kernel route's group width 64) on its
    fused_res2 route: the Res2 chains, ASTP's statistics and the global
    context through the ops; JAX's twin plain."""
    module = jecapa.ECAPA_TDNN(channels=512, feat_dim=24, embed_dim=teu.EMB,
                               global_context_att=True, fused_block=False,
                               fused_tail=False)
    variables = numpy_variables(module, jnp.zeros((2, 48, 24)), seed=5,
                                train=False)
    model = ecapa_tdnn.ECAPA_TDNN(512, 24, teu.EMB, global_context_att=True,
                                  fused=False, fused_res2=True)
    model.load_state_dict(from_jax_variables(variables, "ECAPA_TDNN"),
                          strict=True)
    return module, variables, model.eval(), 24


def _campplus(monkeypatch):
    """CAM++ at growth 32 and bottleneck 128 (the block kernel's shapes),
    init_channels 32, one layer a block on both sides."""
    teu._cut_cam_blocks(monkeypatch)
    module = jcam.CAMPPlus(feat_dim=40, embed_dim=teu.EMB, growth_rate=32,
                           bn_size=4, init_channels=32, fused_blocks=False)
    variables = numpy_variables(module, jnp.zeros((2, 48, 40)), seed=8,
                                train=False)
    model = teu._port_campplus(growth=32, bn_size=4, init=32)
    model.load_state_dict(from_jax_variables(variables, "CAMPPlus"),
                          strict=True)
    return module, variables, model.eval(), 40


PREFIX = "wespeaker_tpu_torch."
FAMILY_OPS = {
    "campplus": {"fused_cam_dense_block": 3, "fused_masked_stats": 1},
    "gemini": {"fused_inv_bottleneck_stage": 4, "fused_masked_stats": 1},
    "resnet34": {"fused_masked_stats": 1},
    "redimnet": {"fused_softmax_stats": 1, "fused_masked_stats": 1},
    "ecapa_res2": {"fused_res2_chain": 3, "fused_softmax_stats": 1,
                   "fused_masked_stats": 1},
}


def _family(name, monkeypatch):
    if name == "ecapa_res2":
        return _ecapa_res2()
    if name == "campplus":
        return _campplus(monkeypatch)
    return teu.build_family(name, monkeypatch)


def _op_nodes(ep):
    out = {}
    for n in ep.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and target.startswith(PREFIX):
            op = target[len(PREFIX):].split(".")[0]
            out[op] = out.get(op, 0) + 1
    return out


@pytest.mark.parametrize("name", list(FAMILY_OPS))
def test_pt2_of_each_family_holds_its_ops_and_matches_jax(
        name, monkeypatch, tmp_path):
    module, variables, model, feat = _family(name, monkeypatch)
    ep = fx_to_onnx.export_program(model, feat, plain=False)
    assert _op_nodes(ep) == FAMILY_OPS[name]
    path = str(tmp_path / f"{name}.pt2")
    torch.export.save(ep, path)
    prog = export_model.load_exported(path, "cpu")
    apply = jax.jit(lambda x: module.apply(variables, x, train=False))
    rng = np.random.default_rng(11)
    for b, t in SHAPES:
        x = rng.normal(size=(b, t, feat)).astype(np.float32)
        with torch.no_grad():
            got = prog(torch.from_numpy(x))
            torch.testing.assert_close(got, model(torch.from_numpy(x)),
                                       rtol=0, atol=0)
        want = np.asarray(apply(jnp.asarray(x)))
        assert got.shape == want.shape == (b, teu.EMB)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel < 1e-4, (name, b, t, rel)


def test_onnx_of_the_fused_res2_ecapa_reaches_no_op_and_matches_jax():
    module, variables, model, feat = _ecapa_res2()
    ep = fx_to_onnx.export_program(model, feat)
    assert _op_nodes(ep) == {}
    assert model.layer2.fused_res2  # the export routed a copy
    blob = fx_to_onnx.convert_program(ep)
    assert onnx_proto.decode_model(blob).opset == 14
    apply = jax.jit(lambda x: module.apply(variables, x, train=False))
    rng = np.random.default_rng(12)
    for b, t in ((3, 77), (1, 200)):
        x = rng.normal(size=(b, t, feat)).astype(np.float32)
        want = np.asarray(apply(jnp.asarray(x)))
        got = onnx_numpy.run(blob, {"feats": x})["embs"]
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert got.shape == want.shape and rel < 1e-4, (b, t, rel)
