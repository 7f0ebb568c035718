"""Deployment export of the port on the CPU, against the JAX package.

- ONNX (export/fx_to_onnx.py) of ECAPA, ResNet34, CAM++, XVEC and
  Gemini, narrow and shallow, with weights from JAX, run by the port's
  numpy executor against JAX's `model.apply` (tests/torch_export_util.py;
  the rest of the families JAX's converter covers are in
  test_torch_export_zoo.py, so that pytest's workers share them). ECAPA
  goes through bin/export_model.py with a mean baked into the graph, XVEC
  through the mnn handoff (no MNNConvert here). CAM++'s three dense
  blocks are cut to one layer each on both sides (their depth is fixed
  in both packages; a full CAM++ takes a minute to trace).
- `encode_model` gives JAX's `onnx_proto` bytes for one graph.
- A `.pt2` of ECAPA c512 (its eval kernels' custom ops as graph nodes)
  round-trips at dynamic B and T; the two custom ops equal their plain
  twins on the CPU at C = 512, and their fake forms give the shapes.
- An unhandled op, and a model that specialises T, raise ConversionError.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")

from tests.torch_export_util import check_family  # noqa: E402
from wespeaker_tpu.export import onnx_proto as j_proto  # noqa: E402
from wespeaker_tpu_torch.bin import export_model  # noqa: E402
from wespeaker_tpu_torch.export import fx_to_onnx  # noqa: E402
from wespeaker_tpu_torch.export import onnx_numpy, onnx_proto  # noqa: E402
from wespeaker_tpu_torch.models import ecapa_tdnn  # noqa: E402
from wespeaker_tpu_torch.ops import mfa_astp, se_block  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["ecapa", "resnet34", "campplus", "xvec",
                                  "gemini"])
def test_onnx_of_each_family_matches_jax(name, monkeypatch, tmp_path):
    check_family(name, monkeypatch, tmp_path)


def _graph(mod):
    w = np.abs(np.random.default_rng(0).normal(size=(3, 4))).astype(
        np.float32)
    return mod.Graph(
        "g",
        [mod.Node("MatMul", ["x", "w"], ["y"], name="mm"),
         mod.Node("Transpose", ["y"], ["z"], {"perm": [1, 0]}),
         mod.Node("ReduceMax", ["z"], ["r"], {"axes": [0], "keepdims": 0}),
         mod.Node("Pow", ["r", "e"], ["p"])],
        [mod.ValueInfo("x", mod.FLOAT, ["B", 3])],
        [mod.ValueInfo("p", mod.FLOAT, ["B"])],
        [mod.Tensor("w", w), mod.Tensor("e", np.full((1,), 2.5, np.float32))])


def test_encode_model_gives_the_jax_writers_bytes():
    blob = onnx_proto.encode_model(_graph(onnx_proto), opset=14)
    assert blob == j_proto.encode_model(_graph(j_proto), opset=14)
    x = np.abs(np.random.default_rng(1).normal(size=(5, 3))).astype(
        np.float32)
    w = _graph(onnx_proto).initializers[0].array
    np.testing.assert_allclose(onnx_numpy.run(blob, {"x": x})["p"],
                               np.power((x @ w).max(1), 2.5), rtol=1e-6)
    # a 0-d tensor keeps no dims (JAX's writer gives it [1])
    t = onnx_proto.Tensor("s", np.asarray(3, np.int64))
    assert onnx_proto._decode_tensor(t.encode()).array.shape == ()


def _ecapa512():
    torch.manual_seed(0)
    model = ecapa_tdnn.ECAPA_TDNN(512, 80, 192, global_context_att=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def test_pt2_round_trip_at_dynamic_batch_and_time(tmp_path):
    """ECAPA c512 takes its kernel route in eval: the program holds the
    SE-block op three times and the tail op once, and on the CPU each op
    runs its plain twin, so the loaded program equals eager."""
    model = _ecapa512()
    ep = fx_to_onnx.export_program(model, 80, plain=False)
    ops = [str(n.target) for n in ep.graph.nodes
           if "wespeaker_tpu_torch" in str(n.target)]
    assert sorted(ops) == (["wespeaker_tpu_torch.fused_mfa_astp.default"]
                           + ["wespeaker_tpu_torch.fused_se_res2_block."
                              "default"] * 3)
    path = str(tmp_path / "ecapa.pt2")
    torch.export.save(ep, path)
    prog = export_model.load_exported(path, "cpu")
    rng = np.random.default_rng(2)
    for b, t in ((3, 77), (1, 137)):
        x = torch.from_numpy(rng.normal(size=(b, t, 80)).astype(np.float32))
        with torch.no_grad():
            torch.testing.assert_close(prog(x), model(x), rtol=0, atol=0)


def test_the_custom_ops_are_their_plain_twins_on_the_cpu():
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = _ecapa512()
    rng = np.random.default_rng(3)
    block = model.layer3.se_res2block
    w = [v.detach() for m in block for v in m.folded()]
    x = torch.from_numpy(rng.normal(size=(2, 9, 512)).astype(np.float32))
    mask = torch.ones(2, 9)
    mask[1, 6:] = 0
    ops = torch.ops.wespeaker_tpu_torch
    for m in (None, mask):
        got = ops.fused_se_res2_block(x, *w, 3, m)
        want = se_block.se_res2_block_reference(x, *w, 3, m)
        assert torch.equal(got, want)
    xs = [torch.from_numpy(rng.normal(size=(2, 9, 512)).astype(np.float32))
          for _ in range(3)]
    tw = [v.detach() for v in model._tail_weights()]
    for m in (None, mask):
        got = ops.fused_mfa_astp(*xs, *tw, m, True)
        want = mfa_astp.mfa_astp_reference(*xs, *tw, mask=m, glob=True)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        assert ops.fused_se_res2_block(
            fx, *[mode.from_tensor(v) for v in w], 3, None).shape == x.shape
        out = ops.fused_mfa_astp(*[mode.from_tensor(v) for v in xs],
                                 *[mode.from_tensor(v) for v in tw], None,
                                 True)
        assert out.shape == (2, 3072) and out.dtype == torch.float32
    # with gradients wanted on the CPU the wrappers stay differentiable
    xg = x.clone().requires_grad_()
    se_block.fused_se_res2_block(xg, *w, dilation=3).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


class _Cumsum(torch.nn.Module):
    def forward(self, x):
        return torch.cumsum(x, dim=1).mean(dim=1)


class _Specialises(torch.nn.Module):
    def forward(self, x):
        return x[:, :int(x.shape[1]) // 2].mean(dim=1)


def test_an_unhandled_op_or_a_specialised_dim_raises():
    with pytest.raises(fx_to_onnx.ConversionError, match="cumsum"):
        fx_to_onnx.convert(_Cumsum(), 8, example_frames=16)
    with pytest.raises(fx_to_onnx.ConversionError, match="specialised T"):
        fx_to_onnx.convert(_Specialises(), 8, example_frames=16)
