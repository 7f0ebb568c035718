"""Port parity for training as the recipes run it: two train steps with
the heads whose train step differs from ArcMargin's (SphereFace2 supplies
its own loss; the softmax recipes' Linear head carries a BatchNorm whose
running statistics the step updates) against the JAX package's
make_train_step, and bin/train.py on the CPU with MUSAN/RIR stores,
worker processes, device-side augmentation and the `feat` data type; the
SSL trainers (DINO, MoCo) with the stores.

The steps: a small ECAPA_TDNN (C=64, feat 24, embed 16, global context,
the layer-by-layer tail on both sides), B=4 chunks of 40 frames, f32,
dither 0 and spec-aug off, SGD as make_optimizer builds it, from the same
weights (the head carried by utils/weights.py). The loss and every
running statistic (the model's and the head's) agree within 1e-4 of each
tensor's largest magnitude, as in tests/test_torch_train.py, which says
why the gradients themselves are held looser there; the head's running
mean, zero up to f32 noise, within 1e-6 absolute.
"""

import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu.models.projections import \
    get_projection as j_get_projection  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.bin import train as train_cli  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.models.projections import get_projection  # noqa
from wespeaker_tpu_torch.train import AugConfig, make_train_step  # noqa
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils.config import load_yaml  # noqa: E402
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_checkpoint, from_jax_variables, to_jax_projection)

from tests.test_torch_data_aug import build_stores, write_corpus  # noqa
from tests.test_torch_heads import _flat, _rel_close  # noqa: E402

torch.set_num_threads(2)
C, FEAT, EMB, NCLS, B = 64, 24, 16, 10, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}
SEED = 3  # the batch seed of tests/test_torch_train.py


@pytest.mark.parametrize("ptype", ["sphereface2", "softmax"])
def test_two_train_steps_match_jax(ptype):
    rng = np.random.default_rng(SEED)
    batches = [{"wav": rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(
                    np.float32),
                "label": rng.integers(0, NCLS, B).astype(np.int32)}
               for _ in range(2)]
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-4, final_lr=5e-5,
                 warm_up_epoch=1)
    m_kw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=3,
                initial_margin=0.0, final_margin=0.2)
    proj_conf = {"project_type": ptype, "embed_dim": EMB,
                 "num_class": NCLS, "scale": 32.0}

    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=False,
                    fused_tail=False)
    jproj = j_get_projection(proj_conf)
    tx = j_opt(OPT_CONF)
    state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(0),
                             feat_dim=FEAT, embed_dim=EMB)
    assert bool(state.proj_stats) == (ptype == "softmax")
    jstep = jax.jit(j_make_train_step(
        jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
        jsched.MarginScheduler(**m_kw),
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
        aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

    model = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True, fused=False)
    proj = get_projection(proj_conf)
    tree = {"params": state.params["model"],
            "batch_stats": state.batch_stats,
            "projection": state.params["projection"]}
    if state.proj_stats:
        tree["projection_batch_stats"] = state.proj_stats
    model_sd, head_sd = from_jax_checkpoint(tree, "ECAPA_TDNN")
    model.load_state_dict(model_sd, strict=True)
    proj.load_state_dict(head_sd, strict=True)
    opt = make_optimizer(OPT_CONF, list(model.parameters())
                         + list(proj.parameters()))
    step = make_train_step(
        model, proj, opt, tsched.ExponentialDecrease(**lr_kw),
        tsched.MarginScheduler(**m_kw),
        FbankConfig(num_mel_bins=FEAT, dither=0.0), AugConfig(spec_aug=False),
        device="cpu")

    for i, batch in enumerate(batches):
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = step(batch)
        for key in ("loss", "acc", "lr", "margin"):
            _rel_close(float(tm[key]), float(jm[key]), 1e-4,
                       f"{ptype} step {i} {key}")
    assert float(jm["margin"]) > 0  # the second step ran with a margin
    want = from_jax_variables({"params": state.params["model"],
                               "batch_stats": state.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            _rel_close(got[key], value, 1e-4, key)
    got_head = to_jax_projection(proj.state_dict())
    if ptype == "softmax":
        assert int(proj.trans_bn.num_batches_tracked) == 2
        stats = dict(_flat(got_head["projection_batch_stats"]))
        want_stats = dict(_flat(state.proj_stats))
        assert sorted(stats) == sorted(want_stats)
        # ECAPA's embedding leaves a train-mode BatchNorm, so its batch
        # mean, and the head's running mean, is zero up to f32 noise
        # (~1e-7): held absolutely, the variance relatively
        np.testing.assert_allclose(stats[("trans_bn", "mean")],
                                   want_stats[("trans_bn", "mean")],
                                   rtol=0, atol=1e-6)
        _rel_close(stats[("trans_bn", "var")],
                   want_stats[("trans_bn", "var")], 1e-4, "head var")
    else:
        assert "projection_batch_stats" not in got_head


def _trainer_config(tmp_path, files, stores, **extra):
    cfg = {
        "exp_dir": str(tmp_path / "exp"), "train_data": files["raw.list"],
        "utt2spk": files["utt2spk"], "data_type": "raw", "num_epochs": 1,
        "samples_per_epoch": 8, "seed": 3, "log_batch_interval": 1,
        "model": "ECAPA_TDNN",
        "model_args": {"channels": C, "feat_dim": FEAT, "embed_dim": EMB},
        "projection_args": {"project_type": "arc_margin"},
        "reverb_data": stores[0], "noise_data": stores[1],
        "dataset_args": {"batch_size": 2, "num_frms": 40, "aug_prob": 0.6,
                         "fbank_args": {"num_mel_bins": FEAT},
                         "filter_args": {"min_num_frames": 20},
                         "shuffle_args": {"shuffle_size": 4},
                         "speed_perturb": True, "spec_aug": True},
        "scheduler_args": {"initial_lr": 0.01, "final_lr": 0.001,
                           "warm_up_epoch": 0},
    }
    for key, value in extra.items():
        node = cfg
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


RUNS = {
    "workers_host_aug": {"dataloader_args.num_workers": 2},
    "device_aug_sphereface2": {"dataset_args.device_aug": True,
                               "dataset_args.aug_prob": 1.0,
                               "projection_args.project_type":
                                   "sphereface2"},
    "feat_softmax": {"data_type": "feat",
                     "projection_args.project_type": "softmax",
                     "model_args.feat_dim": 8,
                     "dataset_args.fbank_args.num_mel_bins": 8},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recipe"))
    return (build_stores(os.path.join(root, "stores")),
            write_corpus(os.path.join(root, "corpus")))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trainer_runs_the_recipe_data_path(tmp_path, corpus, run):
    """bin/train.py on the CPU with the stores: 4 steps, a finite loss in
    every log line, model_0.pt written and loaded with its head."""
    stores, files = corpus
    extra = dict(RUNS[run])
    if extra.get("data_type") == "feat":
        extra["train_data"] = files["feat.list"]
    conf = _trainer_config(tmp_path, files, stores, **extra)
    step = train_cli.train(conf, device="cpu")
    assert step.step == 4
    log = (tmp_path / "exp" / "train.log").read_text()
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in log.splitlines() if " loss " in line]
    assert len(losses) == 4 and np.all(np.isfinite(losses)), log
    configs = load_yaml(str(tmp_path / "exp" / "config.yaml"))
    head = get_projection({**configs["projection_args"], "embed_dim": EMB,
                           "num_class": configs["num_class"], "scale": 32.0})
    model = ECAPA_TDNN(C, configs["model_args"]["feat_dim"], EMB)
    ckpt.load_checkpoint(str(tmp_path / "exp" / "models" / "model_0.pt"),
                         model, head)
    for key, value in step.projection.state_dict().items():
        assert torch.equal(head.state_dict()[key], value), key
    want_classes = 3 if configs["data_type"] == "feat" else 9
    assert configs["num_class"] == want_classes
    if run == "feat_softmax":
        assert int(head.trans_bn.num_batches_tracked) == 4


@pytest.mark.parametrize("trainer", ["dino", "moco"])
def test_ssl_trainers_take_the_stores(tmp_path, corpus, trainer):
    """The SSL trainers with the recipes' `reverb_data` / `noise_data`:
    each view augmented (make_crop_aug over the stores, held to the JAX
    package's in tests/test_torch_data_aug.py), one epoch on the CPU with
    finite losses and the teacher's or query's checkpoint written."""
    from tests.test_torch_ssl_data import DINO_ARGS, _corpus, _write_config
    from wespeaker_tpu_torch.bin import train_contrastive as tc_cli
    from wespeaker_tpu_torch.bin import train_dino as dino_cli

    stores, _ = corpus
    raw, utt2spk = _corpus(str(tmp_path / "data"))
    over = [f"reverb_data={stores[0]}", f"noise_data={stores[1]}"]
    if trainer == "dino":
        conf = _write_config(tmp_path, raw, utt2spk, dino_args=DINO_ARGS)
        _, aug = dino_cli.ssl_dataset(load_yaml(conf) | {
            "reverb_data": stores[0], "noise_data": stores[1]})
        assert aug is not None
        step = dino_cli.train_dino(conf, over + ["stop_epoch=1"],
                                   device="cpu")
    else:
        conf = _write_config(tmp_path, raw, utt2spk, num_epochs=1,
                             ssl_method="moco",
                             ssl_args={"queue_size": 6, "chunk_sec": 0.8})
        step = tc_cli.train_contrastive(conf, over, device="cpu")
    assert step.step == 4
    log = (tmp_path / "exp" / "train.log").read_text()
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in log.splitlines() if " loss " in line]
    assert len(losses) == 4 and np.all(np.isfinite(losses)), log
    assert (tmp_path / "exp" / "models" / "model_0.pt").exists()
