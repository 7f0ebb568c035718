"""The port stands alone: no file of wespeaker_tpu_torch/, nor
chip_smoke.py, imports JAX, flax, optax or the JAX package, nor msgpack,
h5py, scikit-learn, umap-learn, hdbscan or transformers, which the card's
machine lacks (transformers only inside bin/precompute_feats.py's
`_hf_model`, the hf backend, which raises naming it where it is absent);
and its entry points refuse to run when no card is present unless the
caller asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
# the card's machine has none of msgpack, h5py, sklearn, umap and hdbscan
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wespeaker_tpu", "msgpack",
             "h5py", "sklearn", "umap", "hdbscan", "transformers")
# (file, function) whose imports may name a forbidden package lazily
LAZY = {("bin/precompute_feats.py", "_hf_model"): ("transformers",)}


def _port_files():
    files = sorted((REPO / "wespeaker_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported(tree, skip=()):
    """Imported module names, leaving out the bodies of the functions
    named in `skip`."""
    skipped = {id(n) for f in ast.walk(tree)
               if isinstance(f, ast.FunctionDef) and f.name in skip
               for n in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    names = {str(f.relative_to(REPO / "wespeaker_tpu_torch")) for f in files
             if f.parent != REPO}
    assert {"ops/mfa_astp_vjp.py", "bin/train.py", "train/optim.py",
            "data/dataset.py", "utils/checkpoint.py",
            "utils/schedulers.py", "models/projections.py",
            "ops/cam_block.py", "models/campplus.py",
            "ops/inv_bottleneck.py", "models/gemini_dfresnet.py",
            "ops/conv_dw_pack.py", "ops/res2_chain.py",
            "models/resnet.py", "ssl/dino.py", "ssl/contrastive.py",
            "parallel/mesh.py", "parallel/collect.py",
            "ssl/dataset.py", "ssl/featurize.py", "bin/train_dino.py",
            "bin/train_contrastive.py", "bin/extract.py",
            "utils/kaldi_io.py", "utils/eval_device.py",
            "backend/metrics.py", "backend/scoring.py", "bin/score.py",
            "bin/score_norm.py", "bin/compute_metrics.py",
            "bin/average_model.py", "bin/smoke_quality.py",
            "utils/msgpack.py", "backend/plda.py", "backend/calibration.py",
            "backend/embedding_processing.py", "bin/plda_tools.py",
            "bin/embd_proc.py", "bin/score_calibration.py",
            "bin/prep_data.py", "diar/subsegment.py", "diar/rttm.py",
            "diar/vad.py", "diar/spectral_clusterer.py", "diar/density.py",
            "diar/manifold.py", "diar/umap_clusterer.py",
            "diar/pipeline.py", "bin/diarize.py", "cli/speaker.py",
            "models/eres2net.py", "models/res2net.py", "models/repvgg.py",
            "models/tdnn.py", "models/samresnet.py", "models/xi_vector.py",
            "models/redimnet2.py", "bin/convert_repvgg.py",
            "frontend/tfmel.py", "frontend/wavlm.py", "frontend/w2vbert.py",
            "frontend/whisper_mel.py", "frontend/whisper_encoder.py",
            "frontend/ssl_frontends.py", "models/with_frontend.py",
            "models/whisper_PMFA.py", "models/w2vbert_adapter_mfa.py",
            "utils/lora.py", "bin/precompute_feats.py", "bin/data_dir.py",
            "bin/prep_local.py", "utils/profiling.py",
            "export/onnx_proto.py", "export/onnx_numpy.py",
            "export/fx_to_onnx.py", "bin/export_model.py",
            "bin/infer_demo.py", "runtime_binding.py"} <= names
    bad, lazy = [], []
    for path in files:
        rel = str(path.relative_to(REPO / "wespeaker_tpu_torch")) \
            if path.parent != REPO else path.name
        skip = [f for (p, f) in LAZY if p == rel]
        tree = ast.parse(path.read_text(), str(path))
        for name in _imported(tree, skip):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {name}")
        for f in skip:
            fn = next(n for n in ast.walk(tree)
                      if isinstance(n, ast.FunctionDef) and n.name == f)
            lazy += [n.split(".")[0] for n in _imported(fn)]
    assert not bad, bad
    # the one lazy import is there, and names only what it may
    assert lazy == ["transformers"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from wespeaker_tpu_torch.bin import serve
    from wespeaker_tpu_torch.device import resolve_device
    from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
    from wespeaker_tpu_torch.serving import EmbeddingServer
    from wespeaker_tpu_torch.train import make_eval_embed_fn

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_embed_fn(ECAPA_TDNN(64, 24, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingServer({}, "", port=0,
                        embed_fn=lambda w, m: np.zeros((len(w), 4)))
    cfg = tmp_path / "conf.yaml"
    cfg.write_text("model: ECAPA_TDNN\nmodel_args: {channels: 64}\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--config", str(cfg), "--checkpoint", "none.pt",
                    "--port", "0"])
    from wespeaker_tpu_torch.backend.scoring import TrialScorer
    from wespeaker_tpu_torch.bin import extract, score
    with pytest.raises(RuntimeError, match="CUDA"):
        extract.main(["--config", str(cfg), "--checkpoint", "none.pt",
                      "--data_list", "none.list", "--out_prefix", "emb"])
    with pytest.raises(RuntimeError, match="CUDA"):
        score.main(["--exp_dir", str(tmp_path), "--eval_scp_path",
                    "none.scp", "trials"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TrialScorer({"a": np.ones(4, np.float32)})
    assert resolve_device("cpu").type == "cpu"


def test_diarization_entry_points_raise_without_a_card(no_card, tmp_path):
    from wespeaker_tpu_torch.bin import diarize
    from wespeaker_tpu_torch.cli.speaker import Speaker
    from wespeaker_tpu_torch.diar.pipeline import diarize_wav
    from wespeaker_tpu_torch.serving import build_embed_fn

    cfg = tmp_path / "config.yaml"
    cfg.write_text("model: ECAPA_TDNN\nmodel_args: {channels: 64}\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        diarize.main(["--config", str(cfg), "--checkpoint", "none.pt",
                      "--wav_scp", "none.scp", "--out_rttm", "out.rttm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_embed_fn({}, "none.pt")
    with pytest.raises(RuntimeError, match="CUDA"):
        Speaker(str(tmp_path))
    wav = np.zeros(16000, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        diarize_wav("u", wav, 16000, lambda b: b.mean(1),
                    sad_segments=[(0.0, 1.0)])


def test_wrappers_refuse_devices_without_a_kernel():
    """No wrapper drops to its plain version for anything but a CPU
    tensor."""
    from wespeaker_tpu_torch.ops.conv_dw_pack import dw_pack
    from wespeaker_tpu_torch.ops.inv_bottleneck import (
        fused_inv_bottleneck_stage)
    from wespeaker_tpu_torch.ops.mfa_astp import fused_mfa_astp
    from wespeaker_tpu_torch.ops.mfa_astp_vjp import (mfa_astp_train_bwd,
                                                      mfa_astp_train_fwd)
    from wespeaker_tpu_torch.ops.res2_chain import fused_res2_chain
    from wespeaker_tpu_torch.ops.se_block import fused_se_res2_block

    x = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_se_res2_block(x, *([x] * 16), dilation=2)
    with pytest.raises(ValueError, match="no kernel"):
        fused_mfa_astp(x, x, x, *([x] * 6))
    with pytest.raises(ValueError, match="no kernel"):
        mfa_astp_train_fwd(x, x, x, *([x] * 6))
    with pytest.raises(ValueError, match="no kernel"):
        mfa_astp_train_bwd(x, x, x, *([x] * 9))
    m = torch.empty(1, 4, 8, 32, device="meta").permute(0, 3, 1, 2)
    w = [torch.empty(s, device="meta") for s in (
        (2, 32, 128), (2, 128), (2, 128), (2, 3, 3, 128), (2, 128),
        (2, 128), (2, 128, 32), (2, 32), (2, 32))]
    with pytest.raises(ValueError, match="no kernel"):
        fused_inv_bottleneck_stage(m, *w)
    c = torch.empty(1, 8, 512, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_res2_chain(c, torch.empty(7, 3, 64, 64, device="meta"),
                         *([torch.empty(7, 64, device="meta")] * 3),
                         dilation=2)
    nhwc = torch.empty(1, 4, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dw_pack(nhwc, nhwc)
