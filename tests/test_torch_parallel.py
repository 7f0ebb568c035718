"""Data and model parallelism of the port against the JAX package's global
batch, in two gloo ranks on the CPU.

One group of two rank processes (tests/torch_parallel_ranks.py, which
imports the port only) runs every multi-rank check of this file; the
parent computes the JAX side on the same seeded inputs:
- the collectives (parallel/collect.py) against JAX's on a 2-device CPU
  mesh, within 1e-6;
- one narrow ECAPA step (C=32, feat 40, embed 16, global context, ArcMargin
  over 6 classes, f32, dither 0, spec-aug off), 2 ranks x B=2 against JAX's
  make_train_step on the global B=4 from the same weights: loss, every
  parameter, every BatchNorm buffer and the head within 1e-5 (of each
  tensor's largest magnitude where that exceeds 1), and the parameters'
  updates within 3e-3 of their norms (the gradients at B=4 depend on
  summation order, tests/test_torch_train.py; pool.linear2.bias, whose
  exact gradient is 0, is held by its value only). The two ranks' rows
  differ in their statistics (rank 1's utterances are loud in their
  second half only), and
  the same step with each rank's own BatchNorm statistics misses JAX's loss
  and running statistics by more than 1e-3;
- the model axis (2 ranks, model 2, 3 head rows a rank): both ranks step
  the whole B=4 batch; the loss, the model and the gathered head against
  the same JAX step within 1e-5;
- bin/train.py with distributed_args (two ranks, 16 utterances, batch 2 a
  rank): rank 0 alone writes, epoch_iter is the global batch's, a resume
  loads the checkpoint on both ranks, the ranks end bit-identical; and a
  model: 2 run whose checkpoint holds the whole padded head and loads into
  a one-process model;
- bin/train.py's SIGTERM poll: a signal on one rank reaches every rank's
  poll at the same step, one step late.
The ranks start first and import the port while JAX builds its state;
they run while JAX takes its step. The stripe and `--data_parallel`
extraction need no ranks.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.parallel import collect as jcollect  # noqa: E402
from wespeaker_tpu.parallel import mesh as jmesh  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.bin import extract as t_extract  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from wespeaker_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from wespeaker_tpu_torch.utils import eval_device  # noqa: E402
from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp_dict  # noqa
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa
from tests.torch_parallel_ranks import Ranks, _free_port  # noqa: E402

torch.set_num_threads(2)
C, FEAT, EMB, B = 32, 40, 16, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}
LR = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-4, final_lr=5e-5,
          warm_up_epoch=1)
MARGIN = dict(epoch_iter=2, increase_start_epoch=0, fix_start_epoch=1,
              initial_margin=0.1, final_margin=0.2)


def _batch(rng):
    """B=4 chunks: rows 0-1 (rank 0) steady noise, rows 2-3 (rank 1) quiet
    in their first half and loud in their second, so that the two ranks'
    features have different statistics after CMVN."""
    wav = rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(np.float32)
    wav[2:, :N_SAMPLES // 2] *= 0.01
    return {"wav": wav, "label": np.array([0, 4, 2, 5], np.int32)}


def _jax_step(state, jmodel, jproj, tx, batch):
    step = jax.jit(j_make_train_step(
        jmodel, jproj, tx, jsched.ExponentialDecrease(**LR),
        jsched.MarginScheduler(**MARGIN),
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
        aug=JAug(spec_aug=False), compute_dtype=jnp.float32))
    return step(state, {k: jnp.asarray(v) for k, v in batch.items()})


def _ecapa_inputs(ncls, seed):
    """Port inputs and JAX's (model, head, optimizer, state before the
    step, batch) for an ECAPA + ArcMargin over ncls classes."""
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=False,
                    fused_tail=False)
    jproj = JArcMargin(EMB, ncls)
    tx = j_opt(OPT_CONF)
    state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(seed),
                             feat_dim=FEAT, embed_dim=EMB)
    batch = _batch(np.random.default_rng(seed))
    inputs = {
        "conf": {"C": C, "FEAT": FEAT, "EMB": EMB, "opt": OPT_CONF,
                 "lr": LR, "margin": MARGIN},
        "model": from_jax_variables({"params": state.params["model"],
                                     "batch_stats": state.batch_stats}),
        "head": torch.from_numpy(np.array(
            state.params["projection"]["weight"])),
        "batch": batch}
    return inputs, (state, jmodel, jproj, tx, batch)


def _corpus(root, n_spk=4, n_utt=4, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lines, u2s = [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            path = os.path.join(root, f"{key}.wav")
            n = int(rng.uniform(0.9, 1.4) * 16000)
            write_wav(path, (rng.uniform(-0.3, 0.3, n) * (1 + s)).astype(
                np.float32), 16000)
            lines.append(json.dumps({"key": key, "wav": path,
                                     "spk": f"spk{s}"}))
            u2s.append(f"{key} spk{s}")
    raw = os.path.join(root, "raw.list")
    with open(raw, "w") as f:
        f.write("\n".join(lines) + "\n")
    utt2spk = os.path.join(root, "utt2spk")
    with open(utt2spk, "w") as f:
        f.write("\n".join(u2s) + "\n")
    return raw, utt2spk


def _train_config(root, raw, utt2spk, name, **extra):
    cfg = {
        "exp_dir": os.path.join(root, name), "train_data": raw,
        "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 1, "seed": 3,
        "log_batch_interval": 1, "model": "ECAPA_TDNN",
        "model_args": {"channels": 16, "feat_dim": 24, "embed_dim": 8,
                       "global_context_att": True},
        "projection_args": {"project_type": "arc_margin"},
        "dataset_args": {"batch_size": 2, "num_frms": 30,
                         "fbank_args": {"num_mel_bins": 24},
                         "filter_args": {"min_num_frames": 20},
                         "speed_perturb": False, "spec_aug": True},
        "scheduler_args": {"initial_lr": 0.1, "final_lr": 0.01,
                           "warm_up_epoch": 0}, **extra}
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg["exp_dir"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank check of this file in one group of two ranks,
    started first: they import the port while JAX builds its state, and
    run while JAX takes its step."""
    root = str(tmp_path_factory.mktemp("ranks"))
    group = Ranks(root)
    try:
        rng = np.random.default_rng(7)
        emb = rng.standard_normal((8, 16)).astype(np.float32)
        cohort = rng.standard_normal((12, 16)).astype(np.float32)
        ecapa, jax_args = _ecapa_inputs(6, 0)
        raw, utt2spk = _corpus(os.path.join(root, "data"))
        config, exp_dir = _train_config(root, raw, utt2spk, "dp")
        raw3, utt2spk3 = _corpus(os.path.join(root, "data3"), n_spk=3)
        axis_config, axis_dir = _train_config(
            root, raw3, utt2spk3, "mp", parallel_args={"model": 2})
        group.give({
            "scenarios": ["collectives", "ecapa", "ecapa_model_axis",
                          "trainer", "trainer_model_axis", "preempt"],
            "collectives": {"emb": emb, "cohort": cohort, "top_n": 5},
            "ecapa": ecapa, "ecapa_model_axis": ecapa,
            "trainer": {"config": config, "exp_dir": exp_dir,
                        "coordinator": f"localhost:{_free_port()}"},
            "trainer_model_axis": {
                "config": axis_config, "exp_dir": axis_dir,
                "coordinator": f"localhost:{_free_port()}"},
            "preempt": {}})
        after, metrics = _jax_step(*jax_args)
    finally:
        out = group.wait()
    return {"out": out, "emb": emb, "cohort": cohort,
            "ecapa": (jax_args[0], after, metrics),
            "exp_dir": exp_dir, "axis_dir": axis_dir, "axis_config":
            axis_config}


def _close(got, want, tol, what):
    """max |got - want| within tol of max(1, max |want|); returns the
    error on that scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"
    return err


def test_collectives_match_jax_on_a_two_device_mesh(ranks):
    mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    emb = jnp.asarray(ranks["emb"])
    gathered = np.asarray(jcollect.all_gather_embeddings(emb, mesh))
    mean, std = (np.asarray(a) for a in jcollect.sharded_cohort_stats(
        emb, jnp.asarray(ranks["cohort"]), mesh, top_n=5))
    affinity = np.asarray(jcollect.sharded_affinity(emb, mesh))
    out = [o["collectives"] for o in ranks["out"]]
    for o in out:
        np.testing.assert_allclose(o["gathered"].numpy(), gathered,
                                   atol=1e-6)
    np.testing.assert_allclose(
        torch.cat([o["mean"] for o in out]).numpy(), mean, atol=1e-6)
    np.testing.assert_allclose(
        torch.cat([o["std"] for o in out]).numpy(), std, atol=1e-6)
    np.testing.assert_allclose(
        torch.cat([o["affinity"] for o in out]).numpy(), affinity,
        atol=1e-6)


def _against_jax(got, before, after, metrics, tol=1e-5):
    """A rank's step (loss, model, head) against JAX's state after the
    step; returns the largest error over the BatchNorm buffers."""
    _close(got["loss"], float(metrics["loss"]), tol, "loss")
    want = from_jax_variables({"params": after.params["model"],
                               "batch_stats": after.batch_stats})
    start = from_jax_variables({"params": before.params["model"],
                                "batch_stats": before.batch_stats})
    stats_err = 0.0
    for key, value in want.items():
        g = got["model"][key]
        if key.endswith("num_batches_tracked"):
            assert int(g) == 1, key
            continue
        err = _close(g, value, tol, key)
        if key.endswith(("running_mean", "running_var")):
            stats_err = max(stats_err, err)
        elif key != "pool.linear2.bias":  # its exact gradient is 0
            d_got = (g - start[key]).numpy()
            d_want = (value - start[key]).numpy()
            rel = np.linalg.norm(d_got - d_want) / max(
                np.linalg.norm(d_want), 1e-12)
            assert rel <= 3e-3, f"update of {key}: {rel:.3g}"
    _close(got["head"]["weight"], after.params["projection"]["weight"],
           tol, "head")
    return stats_err


def test_two_rank_ecapa_step_is_jax_step_on_the_global_batch(ranks):
    state, after, metrics = ranks["ecapa"]
    r0, r1 = (o["ecapa"]["global"] for o in ranks["out"])
    _against_jax(r0, state, after, metrics)
    # the ranks end bit-identical
    assert r0["loss"] == r1["loss"]
    for key, value in r0["model"].items():
        assert torch.equal(value, r1["model"][key]), key
    assert torch.equal(r0["head"]["weight"], r1["head"]["weight"])


def test_per_rank_batch_norm_misses_the_global_step(ranks):
    state, after, metrics = ranks["ecapa"]
    got = ranks["out"][0]["ecapa"]["per_rank"]
    with pytest.raises(AssertionError):
        _against_jax(got, state, after, metrics, tol=1e-3)
    want = from_jax_variables({"params": after.params["model"],
                               "batch_stats": after.batch_stats})
    errs = [_close(got["model"][k], want[k], np.inf, k) for k in want
            if k.endswith("running_var")]
    assert max(errs) > 1e-3, errs


def test_model_axis_head_matches_the_single_device_step(ranks):
    state, after, metrics = ranks["ecapa"]
    r0, r1 = (o["ecapa_model_axis"] for o in ranks["out"])
    for got in (r0, r1):
        _against_jax(got, state, after, metrics)
    assert r0["head"]["weight"].shape == (6, EMB)


def test_trainer_ranks_write_once_and_resume(ranks):
    r0, r1 = (o["trainer"] for o in ranks["out"])
    with open(os.path.join(ranks["exp_dir"], "config.yaml")) as f:
        conf = yaml.safe_load(f)
    # 16 utterances, batch 2 on each of 2 data ranks: JAX's global epoch
    assert conf["epoch_iter"] == 16 // (2 * 2)
    assert r0["steps"] == r1["steps"] == 4
    # epoch 0, then epoch 1 of the resumed run
    assert r0["writes"] == ["model_0.pt", "model_1.pt"]
    assert r1["writes"] == []
    saved = torch.load(os.path.join(ranks["exp_dir"], "models",
                                    "model_0.pt"), weights_only=True)
    for r in (r0, r1):
        assert r["resumed_steps"] == 4 and r["again_steps"] == 8
        for key, value in saved["state_dict"].items():
            assert torch.equal(r["resumed"][key], value), key
    for key, value in r0["again"].items():
        assert torch.equal(value, r1["again"][key]), key
    assert not torch.equal(r0["again"]["layer1.conv.weight"],
                           saved["state_dict"]["layer1.conv.weight"])


def test_model_axis_trainer_checkpoint_holds_the_whole_head(ranks):
    r0, r1 = (o["trainer_model_axis"] for o in ranks["out"])
    assert r0["writes"] == ["model_0.pt"] and r1["writes"] == []
    with open(os.path.join(ranks["axis_dir"], "config.yaml")) as f:
        conf = yaml.safe_load(f)
    # 3 speakers padded to a multiple of the model axis, JAX's
    # -(-3 // 2) * 2 (wespeaker_tpu/bin/train.py); the two ranks are one
    # data stripe, so the epoch is 12 utterances // batch 2
    assert conf["num_class"] == 4 and conf["epoch_iter"] == 6
    assert r0["steps"] == r1["steps"] == 6
    path = os.path.join(ranks["axis_dir"], "models", "model_0.pt")
    _, head_sd = ckpt.read_checkpoint(path, "ECAPA_TDNN")
    assert head_sd["weight"].shape == (4, 8)
    model = ECAPA_TDNN(16, 24, 8, global_context_att=True)
    head = ArcMarginProduct(8, 4)
    ckpt.load_checkpoint(path, model, head)
    assert torch.equal(head.weight.detach(), head_sd["weight"])
    for key, value in r0["again"].items():
        assert torch.equal(value, r1["again"][key]), key


def test_sigterm_poll_agrees_one_step_late(ranks):
    """bin/train.py's poll over the ranks: rank 1 alone is signalled
    before the third poll, and both ranks answer True from the fourth."""
    r0, r1 = (o["preempt"] for o in ranks["out"])
    assert r0 == r1 == [False, False, False, True, True]


@pytest.mark.parametrize("world,model,want", [
    (1, 1, [(0, 1)]),
    (2, 1, [(0, 2), (1, 2)]),
    (2, 2, [(0, 1), (0, 1)]),
    (4, 2, [(0, 2), (0, 2), (1, 2), (1, 2)]),
    (8, 4, [(r // 4, 2) for r in range(8)]),
    (4, 4, [(0, 1)] * 4),
])
def test_stripe_matches_jax(world, model, want, monkeypatch):
    """parallel/mesh.py's stripe against JAX's process_data_stripe on a
    mesh of one CPU device a process (the process index mocked), the
    cases of tests/test_multihost.py's stripe test."""
    class Dev:
        def __init__(self, i):
            self.process_index = i

    devices = np.asarray([Dev(i) for i in range(world)]).reshape(
        world // model, model)

    class FakeMesh:
        def __init__(self):
            self.devices = devices
            self.shape = {"data": world // model, "model": model}

    got, jax_got = [], []
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        jax_got.append(jmesh.process_data_stripe(FakeMesh()))
        got.append(tmesh.process_data_stripe(
            tmesh.Mesh(r, world, world // model, model)))
    assert got == jax_got == want


def test_data_parallel_extraction_matches_one_replica(tmp_path):
    """--data_parallel with two replicas on the CPU against one replica on
    the same list: the same keys in the same order within 1e-6, and
    batch_size 3 rounded up to 4 (two replicas), as JAX's rounds it."""
    torch.manual_seed(0)
    model = ECAPA_TDNN(16, 24, 8, global_context_att=True)
    ckpt.save_checkpoint(str(tmp_path / "model.pt"), model)
    conf = {"model": "ECAPA_TDNN",
            "model_args": {"channels": 16, "feat_dim": 24, "embed_dim": 8,
                           "global_context_att": True},
            "dataset_args": {"fbank_args": {"num_mel_bins": 24}}}
    with open(tmp_path / "conf.yaml", "w") as f:
        yaml.safe_dump(conf, f)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(7):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, rng.uniform(-0.3, 0.3, int(
            rng.uniform(0.5, 2.5) * 16000)).astype(np.float32), 16000)
        lines.append(json.dumps({"key": f"u{i}", "wav": path}))
    (tmp_path / "wav.list").write_text("\n".join(lines) + "\n")

    def run(name, batch_size, **kw):
        scp = t_extract.extract(
            str(tmp_path / "conf.yaml"), str(tmp_path / "model.pt"),
            str(tmp_path / "wav.list"), str(tmp_path / name),
            batch_size=batch_size, device="cpu", **kw)
        with open(scp) as f:
            keys = [line.split()[0] for line in f]
        return keys, read_vec_scp_dict(scp)

    one_keys, one = run("one", 4)
    dp_keys, dp = run("dp", 3, data_parallel=True, devices=["cpu", "cpu"])
    assert dp_keys == one_keys and len(one_keys) == 7
    for key in one_keys:
        np.testing.assert_allclose(dp[key], one[key], atol=1e-6)
    assert eval_device.round_batch(3, 2) == 4
