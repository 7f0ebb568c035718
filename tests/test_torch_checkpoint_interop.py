"""Port parity for checkpoints: the JAX package's flax msgpack `.ckpt`
files read and written by the port (utils/msgpack.py, utils/weights.py,
utils/checkpoint.py), on the CPU.

- Writer: the port's bytes equal the JAX package's `save_checkpoint` for
  a flax ECAPA {params, batch_stats, projection} tree, a ResNet tree with
  `projection_batch_stats` and a DINO checkpoint tree, each built on the
  port's side from its state_dicts (to_jax_variables,
  to_jax_projection); flax's `msgpack_restore` reads the port's bytes
  back to the same leaves.
- Reader: flax's bytes restore to equal arrays, with a 0-d int leaf, a
  bfloat16 leaf (a torch.bfloat16 tensor in the port) and a chunked leaf
  (flax's MAX_CHUNK_SIZE patched small inside the test only, where the
  port's writer with its own limit patched gives the same bytes).
- `to_jax_variables(from_jax_variables(v))` returns v exactly for ECAPA,
  ResNet (BasicBlock, Bottleneck), CAM++, Gemini and ReDimNet (the three
  narrow configurations of tests/test_torch_redimnet.py), at the widths
  of their parity tests (parameter trees from jax.eval_shape, filled from
  a seed).
- Extraction: a narrow ECAPA (C=64) and a ResNet18 at the SRE shape
  (feat 40, TSTP), saved by JAX's save_checkpoint with a projection,
  loaded by the port's load_model_for_eval, give embeddings within 1e-5
  (of the largest magnitude) of JAX's checkpoint load (the one that its
  load_model_for_eval makes, against the model's variable tree) plus
  forward (f32).
- average_model over three `.ckpt` files writes the bytes of JAX's
  average_checkpoints plus save_checkpoint.
- bin/train.py resumes from `model_1.ckpt` at epoch 2, a larger saved
  projection keeps its first rows, and `model_init` takes a JAX DINO
  checkpoint's teacher backbone.
- Strictness (a deliberate difference): a model leaf missing from the
  `.ckpt` raises in the port, where the JAX package's non-strict load
  keeps the leaf's init.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.bin import extract as j_extract  # noqa: E402
from wespeaker_tpu.models import campplus as jcampplus  # noqa: E402
from wespeaker_tpu.models import ecapa_tdnn as jecapa  # noqa: E402
from wespeaker_tpu.models import gemini_dfresnet as jgemini  # noqa: E402
from wespeaker_tpu.models import redimnet as jredimnet  # noqa: E402
from wespeaker_tpu.models import resnet as jresnet  # noqa: E402
from wespeaker_tpu.ssl.dino import DINOHead  # noqa: E402
from wespeaker_tpu.utils import checkpoint as jckpt  # noqa: E402
from wespeaker_tpu_torch.bin import average_model as t_avg  # noqa: E402
from wespeaker_tpu_torch.bin import train as train_cli  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.train.composite import build_model  # noqa: E402
from wespeaker_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from wespeaker_tpu_torch.utils import msgpack  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
K = ((3, 3),)
# the narrow models of the port's parity tests: (name, flax module, feat)
FAMILIES = {
    "ecapa": ("ECAPA_TDNN", lambda: jecapa.ECAPA_TDNN(
        channels=64, feat_dim=24, embed_dim=16, global_context_att=True),
        24),
    "resnet_basic": ("ResNet34", lambda: jresnet.ResNet(
        jresnet.BasicBlock, (1, 1, 1, 1), m_channels=8, feat_dim=20,
        embed_dim=16), 20),
    "resnet_bottleneck": ("ResNet34", lambda: jresnet.ResNet(
        jresnet.Bottleneck, (1, 1, 1, 1), m_channels=8, feat_dim=20,
        embed_dim=16, two_emb_layer=True), 20),
    "campplus": ("CAMPPlus", lambda: jcampplus.CAMPPlus(
        feat_dim=40, embed_dim=32, fused_blocks=False), 40),
    "gemini": ("Gemini_DF_ResNet114", lambda: jgemini.Gemini_DF_ResNet(
        depths=(1, 1, 2, 1), dims=(8, 8, 16, 16, 32), embed_dim=24,
        feat_dim=40), 40),
    "redimnet_fwse_convatt": ("ReDimNetB2", lambda: jredimnet.ReDimNet(
        feat_dim=16, C=4, block_1d_type="conv+att",
        block_2d_type="basic_resnet_fwse",
        stages_setup=((1, 1, 1, K, 4), (2, 1, 2, K, 4)), group_divisor=2,
        embed_dim=8, two_emb_layer=True), 16),
    "redimnet_convnext_att": ("ReDimNetB2", lambda: jredimnet.ReDimNet(
        feat_dim=18, C=4, block_1d_type="att", block_2d_type="convnext_like",
        stages_setup=((3, 1, 2, K, None), (1, 1, 1, K, 3)), group_divisor=2,
        embed_dim=8), 18),
    "redimnet_basic_fc_mfa": ("ReDimNetB2", lambda: jredimnet.ReDimNet(
        feat_dim=20, C=4, block_1d_type="fc", block_2d_type="basic_resnet",
        stages_setup=((2, 1, 1, K, 4), (1, 1, 1, K, None), (2, 1, 1, K, 5)),
        group_divisor=None, embed_dim=8, out_channels=24), 20),
}


def _filled(module, example, seed, **kw):
    """module's variables from jax.eval_shape (no compute), filled from a
    seed: normal leaves, BN variances in U(0.5, 1.5); a numpy tree."""
    shapes = jax.eval_shape(lambda key, x: module.init(key, x, **kw),
                            jax.random.PRNGKey(0), example)
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.tree_util.tree_map(lambda s: s, shapes))
    out = {}
    for path, s in flat.items():
        v = (rng.uniform(0.5, 1.5, s.shape) if path[-1] == "var"
             else 0.3 * rng.normal(size=s.shape))
        out[path] = v.astype(np.float32)
    return unflatten_dict(out)


def _family_vars(key, seed=0):
    name, make, feat = FAMILIES[key]
    return name, _filled(make(), jnp.zeros((1, 40, feat)), seed)


def _equal_trees(a, b):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k


@pytest.mark.parametrize("key", list(FAMILIES))
def test_to_jax_variables_inverts_from_jax_variables(key):
    name, variables = _family_vars(key)
    sd = weights.from_jax_variables(variables, name)
    _equal_trees(weights.to_jax_variables(sd, name), variables)


def _jax_bytes(tree, tmp_path):
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, tree)
    with open(path, "rb") as f:
        return f.read()


def _via_port(variables, name):
    """The flax tree rebuilt on the port's side from its state_dict."""
    return weights.to_jax_variables(
        weights.from_jax_variables(variables, name), name)


def _dino_tree(seed):
    """The JAX DINO trainer's model_<n>.ckpt: the teacher's backbone as
    params/batch_stats, the student's backbone and BN head beside."""
    _, backbone = _family_vars("ecapa", seed)
    head = _filled(DINOHead(out_dim=48, use_bn=True, hidden_dim=32,
                            bottleneck_dim=16), jnp.zeros((2, 16)), seed + 1)
    return {"params": backbone["params"],
            "batch_stats": backbone["batch_stats"],
            "student_params": {"backbone": backbone["params"],
                               "head": head["params"]},
            "student_stats": {"backbone": backbone["batch_stats"],
                              "head": head["batch_stats"]}}


@pytest.mark.parametrize("kind", ["ecapa", "resnet_proj_stats", "dino"])
def test_port_writer_gives_jax_bytes(kind, tmp_path):
    rng = np.random.default_rng(11)
    if kind == "dino":
        want = _dino_tree(3)
        backbone = _via_port({"params": want["params"],
                              "batch_stats": want["batch_stats"]},
                             "ECAPA_TDNN")
        head = _via_port({"params": want["student_params"]["head"],
                          "batch_stats": want["student_stats"]["head"]},
                         "DINOHead")
        got = {**backbone,
               "student_params": {"backbone": backbone["params"],
                                  "head": head["params"]},
               "student_stats": {"backbone": backbone["batch_stats"],
                                 "head": head["batch_stats"]}}
    else:
        key = "ecapa" if kind == "ecapa" else "resnet_basic"
        name, want = _family_vars(key, 1)
        head = ArcMarginProduct(16, 37)
        torch.nn.init.normal_(head.weight)
        want = {**want, "projection": {"weight": head.weight.detach()
                                       .numpy().copy()}}
        got = {**_via_port(want, name),
               **weights.to_jax_projection(head.state_dict())}
        if kind == "resnet_proj_stats":
            stats = {"bn": {"mean": rng.normal(size=16).astype(np.float32),
                            "var": rng.uniform(1, 2, 16).astype(np.float32)}}
            want["projection_batch_stats"] = stats
            got["projection_batch_stats"] = stats
    data = msgpack.serialize(got)
    assert data == _jax_bytes(want, tmp_path)
    _equal_trees(fser.msgpack_restore(data), want)
    _equal_trees(msgpack.restore(data), want)


def test_port_reader_restores_flax_bytes(monkeypatch):
    rng = np.random.default_rng(12)
    big = rng.normal(size=(9, 7)).astype(np.float32)
    tree = {"step": np.asarray(7, np.int32), "neg": np.asarray(-70000),
            "bf16": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
            "layer": {"kernel": rng.normal(size=(2, 3, 4)).astype(
                np.float32), "big": big}, "empty": {}}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    data = fser.msgpack_serialize(jax.tree_util.tree_map(np.asarray, tree))
    assert b"__msgpack_chunked_array__" in data
    got = msgpack.restore(data)
    assert got["step"].shape == () and got["step"].dtype == np.int32
    assert int(got["step"]) == 7 and int(got["neg"]) == -70000
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.uint16), torch.from_numpy(
        np.asarray(tree["bf16"]).view(np.uint16).astype(np.int32)).to(
            torch.uint16))
    assert np.array_equal(got["layer"]["big"], big)
    assert np.array_equal(got["layer"]["kernel"], tree["layer"]["kernel"])
    assert got["empty"] == {}
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    assert msgpack.serialize(got) == data


SRE_SHAPE = {
    "ecapa": {"model": "ECAPA_TDNN", "model_args": {
        "channels": 64, "feat_dim": 40, "embed_dim": 32,
        "pooling_func": "TSTP"}},
    "resnet": {"model": "ResNet18", "model_args": {
        "feat_dim": 40, "embed_dim": 32, "pooling_func": "TSTP"}},
}


@pytest.mark.parametrize("kind", ["ecapa", "resnet"])
def test_jax_ckpt_extracts_as_jax(kind, tmp_path):
    """A JAX-written `.ckpt` (with its projection) at the SRE shape, loaded
    by each package's load_model_for_eval: embeddings within 1e-5."""
    configs = SRE_SHAPE[kind]
    built = j_extract.build_model(configs)
    variables = _filled(built.model, jnp.zeros((1, 32, 40)), 5, train=False)
    tree = {**variables, "projection": {"weight": np.random.default_rng(
        6).normal(size=(10, 32)).astype(np.float32)}}
    path = str(tmp_path / "avg_model.ckpt")
    jckpt.save_checkpoint(path, tree)
    feat = np.random.default_rng(7).normal(size=(3, 200, 40)).astype(
        np.float32)
    # JAX's load_model_for_eval is an init (eager, ~6-10 s here) and then
    # this load against its variable tree
    jvars = jckpt.load_checkpoint(path, variables)
    want = np.asarray(jax.jit(built.model.apply)(jvars, jnp.asarray(feat)))
    model = load_model_for_eval(configs, path, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (3, 32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_average_model_gives_jax_bytes(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    _, base = _family_vars("resnet_basic", 2)
    rng = np.random.default_rng(13)
    for epoch in (0, 1, 2, 3):
        tree = jax.tree_util.tree_map(
            lambda v: (v + 0.01 * rng.normal(size=v.shape)).astype(
                np.float32), base)
        sd = weights.from_jax_variables(tree, "ResNet34")
        ckpt.save_msgpack_checkpoint(
            str(models / f"model_{epoch}.ckpt"),
            weights.to_jax_variables(sd, "ResNet34"))
    (models / "avg_model.ckpt").write_bytes(b"")  # excluded by name
    dst = str(tmp_path / "avg_model.ckpt")
    t_avg.main(["--src_path", str(models), "--dst_model", dst, "--num", "3"])
    paths = jckpt.find_epoch_checkpoints(str(models))[-3:]
    assert ckpt.find_epoch_checkpoints(str(models), "ckpt")[-3:] == paths
    with open(dst, "rb") as f:
        assert f.read() == _jax_bytes(jckpt.average_checkpoints(paths),
                                      tmp_path)


def _corpus(root, n_spk=3, n_utt=2):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    lines, u2s = [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, (rng.uniform(-0.3, 0.3, 16000) * (1 + s)).astype(
                np.float32), 16000)
            lines.append(json.dumps({"key": key, "wav": path,
                                     "spk": f"spk{s}"}))
            u2s.append(f"{key} spk{s}")
    with open(os.path.join(root, "raw.list"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "utt2spk"), "w") as f:
        f.write("\n".join(u2s) + "\n")
    return os.path.join(root, "raw.list"), os.path.join(root, "utt2spk")


def _train_config(tmp_path):
    raw, utt2spk = _corpus(str(tmp_path / "data"))
    cfg = {
        "exp_dir": str(tmp_path / "exp"), "train_data": raw,
        "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 3, "seed": 3,
        "log_batch_interval": 1, "model": "ECAPA_TDNN",
        "model_args": {"channels": 64, "feat_dim": 24, "embed_dim": 16},
        "projection_args": {"project_type": "arc_margin"},
        "dataset_args": {"batch_size": 2, "num_frms": 40,
                         "fbank_args": {"num_mel_bins": 24},
                         "filter_args": {"min_num_frames": 20},
                         "speed_perturb": False, "spec_aug": False},
        "scheduler_args": {"initial_lr": 0.1, "final_lr": 0.01,
                           "warm_up_epoch": 0},
    }
    import yaml
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def test_trainer_resumes_and_inits_from_jax_ckpt(tmp_path):
    conf, cfg = _train_config(tmp_path)
    torch.manual_seed(0)
    model = build_model(cfg)
    head = ArcMarginProduct(16, 5)  # 3 speakers now, 5 rows saved
    tree = {**weights.to_jax_variables(model.state_dict(), "ECAPA_TDNN"),
            **weights.to_jax_projection(head.state_dict())}
    path = str(tmp_path / "model_1.ckpt")
    ckpt.save_msgpack_checkpoint(path, tree)
    assert ckpt.parse_start_epoch(path) == 2
    assert ckpt.parse_start_epoch(str(tmp_path / "preempt_model_4.ckpt")) == 4
    assert ckpt.checkpoint_format(path) == "msgpack"

    fewer = ArcMarginProduct(16, 3)
    loaded = ckpt.load_checkpoint(path, build_model(cfg), fewer)
    assert torch.equal(fewer.weight, head.weight[:3])
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key

    step = train_cli.train(conf, [f"checkpoint={path}"], device="cpu")
    assert step.step == 9  # epoch 2 of 3 steps, after 2 done
    log = (tmp_path / "exp" / "train.log").read_text()
    assert "at epoch 2" in log and "epoch 2 it 0/3" in log
    assert "epoch 1 it" not in log

    # model_init from a JAX DINO checkpoint: the teacher's backbone
    dino = {**tree, "student_params": {"backbone": tree["params"]},
            "student_stats": {"backbone": tree["batch_stats"]}}
    dpath = str(tmp_path / "dino_model_9.ckpt")
    ckpt.save_msgpack_checkpoint(dpath, {k: v for k, v in dino.items()
                                         if k != "projection"})
    step = train_cli.train(conf, [f"model_init={dpath}", "num_epochs=1",
                                  f"exp_dir={tmp_path / 'ft'}"],
                           device="cpu")
    assert step.step == 3
    assert "initialized model from" in (tmp_path / "ft" / "train.log"
                                        ).read_text()


def test_missing_leaf_raises_where_jax_keeps_the_init(tmp_path):
    """A deliberate difference: the JAX package's load_checkpoint (strict
    False) keeps the init of a leaf the file lacks; the port's strict load
    raises, as its `.pt` path does."""
    _, variables = _family_vars("ecapa", 4)
    flat = flatten_dict(variables)
    dropped = ("params", "pool", "linear1", "bias")
    assert dropped in flat
    del flat[dropped]
    path = str(tmp_path / "model_0.ckpt")
    jckpt.save_checkpoint(path, unflatten_dict(flat))
    kept = jckpt.load_checkpoint(path, variables)
    assert np.array_equal(flatten_dict(kept)[dropped], variables["params"][
        "pool"]["linear1"]["bias"])
    configs = {"model": "ECAPA_TDNN", "model_args": {
        "channels": 64, "feat_dim": 24, "embed_dim": 16,
        "global_context_att": True}}
    with pytest.raises(RuntimeError, match="pool.linear1.bias"):
        load_model_for_eval(configs, path, device="cpu")
    with open(path, "wb") as f:
        f.write(b"\x89HDF\r\n")
    with pytest.raises(ValueError, match="HDF5"):
        ckpt.load_checkpoint(path, build_model(configs))
    with open(path, "wb") as f:
        f.write(b"\x00\x01")
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_checkpoint(path, build_model(configs))
