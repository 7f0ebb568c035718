"""The narrow models of the port's ONNX tests (tests/test_torch_export*.py)
with weights from the JAX package, and the check that runs each family's
ONNX, decoded by the port's reader and run by its numpy executor, against
JAX's `model.apply` at (B, T) = (3, 77) and (1, 200), within 1e-4 of the
largest magnitude (the JAX converter's own test's bar)."""

import numpy as np
import torch
import yaml
import jax
import jax.numpy as jnp

from tests.torch_zoo_util import numpy_variables
from wespeaker_tpu.models import campplus as jcam
from wespeaker_tpu.models import ecapa_tdnn as jecapa
from wespeaker_tpu.models import eres2net as jeres
from wespeaker_tpu.models import gemini_dfresnet as jgem
from wespeaker_tpu.models import redimnet as jred
from wespeaker_tpu.models import redimnet2 as jred2
from wespeaker_tpu.models import repvgg as jrep
from wespeaker_tpu.models import res2net as jres2
from wespeaker_tpu.models import resnet as jresnet
from wespeaker_tpu.models import samresnet as jsam
from wespeaker_tpu.models import tdnn as jtdnn
from wespeaker_tpu_torch.bin import export_model
from wespeaker_tpu_torch.export import fx_to_onnx, onnx_numpy, onnx_proto
from wespeaker_tpu_torch.models import (campplus, ecapa_tdnn, eres2net,
                                        gemini_dfresnet, redimnet, redimnet2,
                                        repvgg, res2net, resnet, samresnet,
                                        tdnn)
from wespeaker_tpu_torch.utils.weights import from_jax_variables

EMB = 16
SHAPES = ((3, 77), (1, 200))
K = ((3, 3),)
CAM_LAYERS = (12, 24, 16)  # both packages' CAM++ blocks
_REP = dict(strides=(1, 1, 2, 2, 2), embed_dim=EMB)

# name -> (flax module, port module, the port's weight rules, feat_dim)
FAMILIES = {
    "ecapa": (lambda: jecapa.ECAPA_TDNN(
        channels=32, feat_dim=24, embed_dim=EMB, global_context_att=True,
        fused_block=False, fused_tail=False),
        lambda: ecapa_tdnn.ECAPA_TDNN(32, 24, EMB, global_context_att=True),
        "ECAPA_TDNN", 24),
    "resnet34": (lambda: jresnet.ResNet(
        jresnet.BasicBlock, (1, 1, 1, 1), m_channels=8, feat_dim=40,
        embed_dim=EMB),
        lambda: resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), m_channels=8,
                              feat_dim=40, embed_dim=EMB), "ResNet34", 40),
    "campplus": (lambda: jcam.CAMPPlus(feat_dim=40, embed_dim=EMB,
                                       growth_rate=8, bn_size=2,
                                       init_channels=16, fused_blocks=False),
                 None, "CAMPPlus", 40),
    "xvec": (lambda: jtdnn.XVEC(40, 16, 24, EMB),
             lambda: tdnn.XVEC(40, 16, 24, EMB), "XVEC", 40),
    "res2net": (lambda: jres2.Res2Net(8, (1, 1, 1, 1), feat_dim=40,
                                      embed_dim=EMB),
                lambda: res2net.Res2Net(8, (1, 1, 1, 1), feat_dim=40,
                                        embed_dim=EMB), "Res2Net34_Base", 40),
    "eres2net": (lambda: jeres.ERes2Net(8, (1, 1, 1, 1), feat_dim=40,
                                        embed_dim=EMB),
                 lambda: eres2net.ERes2Net(8, (1, 1, 1, 1), feat_dim=40,
                                           embed_dim=EMB),
                 "ERes2Net34_Base", 40),
    "gemini": (lambda: jgem.Gemini_DF_ResNet(
        depths=(1, 1, 1, 1), dims=(8, 8, 16, 16, 32), embed_dim=EMB,
        feat_dim=40),
        lambda: gemini_dfresnet.Gemini_DF_ResNet(
            depths=(1, 1, 1, 1), dims=(8, 8, 16, 16, 32), embed_dim=EMB,
            feat_dim=40), "Gemini_DF_ResNet114", 40),
    "samresnet": (lambda: jsam.SimAM_ResNet_ASP(4, (1, 1, 1, 1), EMB, 40),
                  lambda: samresnet.SimAM_ResNet_ASP(4, (1, 1, 1, 1), EMB,
                                                     40),
                  "SimAM_ResNet34_ASP", 40),
    "repvgg": (lambda: jrep.RepVGG(
        (1, 1, 1, 1), width_multiplier=(0.125,) * 4, feat_dim=40, **_REP),
        lambda: repvgg.RepVGG((1, 1, 1, 1), width_multiplier=(0.125,) * 4,
                              feat_dim=40, **_REP), "RepVGG", 40),
    "redimnet": (lambda: jred.ReDimNet(
        feat_dim=16, C=4, block_1d_type="conv+att",
        block_2d_type="basic_resnet_fwse",
        stages_setup=((2, 1, 2, K, 4),), group_divisor=2, embed_dim=EMB),
        lambda: redimnet.ReDimNet(
            feat_dim=16, C=4, block_1d_type="conv+att",
            block_2d_type="basic_resnet_fwse",
            stages_setup=((2, 1, 2, K, 4),), group_divisor=2,
            embed_dim=EMB), "ReDimNetB2", 16),
    "redimnet2": (lambda: jred2.ReDimNet2Wrap(
        F=16, C=4, feat_dim=16, embed_dim=EMB, out_channels=8,
        stages_setup=(((2, 1), 1, 2, K, 4),)),
        lambda: redimnet2.ReDimNet2Wrap(
            F=16, C=4, feat_dim=16, embed_dim=EMB, out_channels=8,
            stages_setup=(((2, 1), 1, 2, K, 4),)),
        "ReDimNet2B0", 16),
}


def _cut_cam_blocks(monkeypatch):
    """Both packages build CAM++'s blocks with CAM_LAYERS layers; build
    them with one layer each instead (the JAX trunk looks the block class
    up at each call, so the patch stays for the test)."""
    orig = jcam.CAMDenseTDNNBlock
    monkeypatch.setattr(jcam, "CAMDenseTDNNBlock",
                        lambda n, *a, **k: orig(1, *a, **k))
    torig = campplus.CAMDenseTDNNBlock
    monkeypatch.setattr(campplus, "CAMDenseTDNNBlock",
                        lambda n, *a, **k: torig(1, *a, **k))


def _port_campplus(growth=8, bn_size=2, init=16):
    """The port's CAM++ (FAMILIES' width by default) with one layer a
    block: the transit layers take what one layer leaves (their outputs
    keep the full model's widths, as JAX's do)."""
    model = campplus.CAMPPlus(feat_dim=40, embed_dim=EMB, growth_rate=growth,
                              bn_size=bn_size, init_channels=init)
    c = init
    for i, n in enumerate(CAM_LAYERS):
        out = (c + n * growth) // 2
        setattr(model.xvector, f"transit{i + 1}",
                campplus.TransitLayer(c + growth, out))
        c = out
    return model


def build_family(name, monkeypatch):
    """(flax module, its variables, the port model on them, feat_dim)."""
    jmake, tmake, rules, feat = FAMILIES[name]
    if name == "campplus":
        _cut_cam_blocks(monkeypatch)
        tmake = _port_campplus
    module = jmake()
    variables = numpy_variables(module, jnp.zeros((2, 48, feat)),
                                seed=len(name), train=False)
    model = tmake()
    model.load_state_dict(from_jax_variables(variables, rules), strict=True)
    return module, variables, model.eval(), feat


def _onnx_of(name, model, feat, tmp_path):
    """Serialized ONNX and the mean it subtracts: ECAPA through the CLI
    with a mean, XVEC through the mnn handoff, the rest by convert()."""
    if name not in ("ecapa", "xvec"):
        return fx_to_onnx.convert(model, feat), 0.0
    ckpt = tmp_path / "model.pt"
    torch.save(model.state_dict(), ckpt)
    conf = tmp_path / "config.yaml"
    model_args = ({"channels": 32, "feat_dim": feat, "embed_dim": EMB,
                   "global_context_att": True} if name == "ecapa" else
                  {"feat_dim": feat, "hid_dim": 16, "stats_dim": 24,
                   "embed_dim": EMB})
    conf.write_text(yaml.safe_dump({
        "model": "ECAPA_TDNN" if name == "ecapa" else "XVEC",
        "model_args": model_args}))
    if name == "xvec":
        path, cmd = export_model.export_mnn(str(conf), str(ckpt),
                                            str(tmp_path / "m.mnn"))
        assert path == str(tmp_path / "m.onnx")
        assert cmd[:4] == ["MNNConvert", "-f", "ONNX", "--modelFile"]
        with open(path, "rb") as f:
            return f.read(), 0.0
    mean = np.random.default_rng(1).normal(size=(EMB,)).astype(np.float32)
    np.save(tmp_path / "mean.npy", mean)
    export_model.main(["--config", str(conf), "--checkpoint", str(ckpt),
                       "--output_model", str(tmp_path / "m.onnx"),
                       "--format", "onnx", "--mean_vec",
                       str(tmp_path / "mean.npy")])
    return (tmp_path / "m.onnx").read_bytes(), mean


def check_family(name, monkeypatch, tmp_path):
    """Convert the family's port model and hold its ONNX to JAX."""
    module, variables, model, feat = build_family(name, monkeypatch)
    blob, mean = _onnx_of(name, model, feat, tmp_path)
    m = onnx_proto.decode_model(blob)
    assert m.opset == 14 and m.ir_version == 8
    (inp,), (out,) = m.graph.inputs, m.graph.outputs
    assert (inp.name, inp.dims, out.name, out.dims) == (
        "feats", ["B", "T", feat], "embs", ["B", EMB])
    apply = jax.jit(lambda x: module.apply(variables, x, train=False))
    rng = np.random.default_rng(7)
    for b, t in SHAPES:
        x = rng.normal(size=(b, t, feat)).astype(np.float32)
        want = np.asarray(apply(jnp.asarray(x))) - mean
        got = onnx_numpy.run(blob, {"feats": x})["embs"]
        assert got.shape == want.shape == (b, EMB)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-4, (name, b, t, rel)
    if name == "ecapa":  # the mean is the graph's last subtraction
        last = [n for n in m.graph.nodes if n.op_type == "Sub"][-1]
        inits = {t.name: t.array for t in m.graph.initializers}
        np.testing.assert_array_equal(inits[last.inputs[1]], mean)
