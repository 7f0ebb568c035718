"""ONNX export of the rest of the families JAX's converter covers
(tests/test_onnx_export.py): Res2Net, ERes2Net, SimAM-ResNet, RepVGG,
ReDimNet and ReDimNet2, narrow and shallow, with weights from JAX, run by
the port's numpy executor against JAX's `model.apply` at (3, 77) and
(1, 200) within 1e-4 of the largest magnitude (tests/torch_export_util.py;
the first five families are in test_torch_export.py)."""

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")

from tests.torch_export_util import check_family  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["res2net", "eres2net", "samresnet",
                                  "repvgg", "redimnet", "redimnet2"])
def test_onnx_of_each_family_matches_jax(name, monkeypatch, tmp_path):
    check_family(name, monkeypatch, tmp_path)
