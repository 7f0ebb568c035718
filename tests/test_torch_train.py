"""Port parity for the training path as a whole: two train steps against
the JAX package's, the data pipeline against the JAX one, the random
augmentations by distribution, and the trainer CLI on the CPU writing a
checkpoint that the extractor loads.

The train steps: a small ECAPA_TDNN (C=64, feat 24, embed 16, global
context) with ArcMargin over 10 classes, B=4 chunks of 40 frames, f32,
dither 0 and spec-aug off, SGD as `make_optimizer` builds it (nesterov,
weight decay 1e-4), from the same weights. The port with fused=True (on
the CPU its autograd Function with the plain forward and backward) is
paired with JAX's fused_tail=True in interpret mode, and fused=False with
JAX's standard path, so both sides sum the MFA conv the same way (three
K-slices, or one concat). Losses, metrics and BatchNorm running
statistics agree within 1e-4 of each tensor's largest magnitude.

Gradients (the momentum buffers) and the parameter updates are held to
3e-3 and parameters to 2e-3, as 2-norm errors relative to each tensor's
2-norm; b2's gradient, zero in exact arithmetic, must stay below 1e-4.
At B=4 the gradients are sensitive to summation order (the embedding
BatchNorm normalises over 4 rows, the SE squeeze feeds a relu over 4
rows), and the JAX package's own two paths, the same math, differ by up
to 1.0e-3 of the MFA conv's gradient after two steps (measured on this
configuration). The LR is 1e-4 for the same reason: at 1e-2 the first
update collapses some attention columns, the ASTP std of those columns
sits at its 1e-7 floor, and the JAX package's two paths then differ by
3-10% in the second step's gradients. The data seed matters: a relu input
within f32 rounding of zero can flip between XLA's and PyTorch's sums,
even with like paired with like, and move a column of a gradient by up to
6e-3 of its max (or 1-2% of an SE layer's gradient norm); with SEED no
such element arises here.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.data.dataset import SpeakerDataset as JDataset  # noqa
from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.bin import train as train_cli  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.data.dataset import SpeakerDataset  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.train import (AugConfig, make_eval_embed_fn,  # noqa
                                       make_train_step)
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.train.train_step import (dither_wav,  # noqa: E402
                                                  spec_aug_batch)
from wespeaker_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils.config import load_yaml  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
C, FEAT, EMB, NCLS, B = 64, 24, 16, 10, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}


def _trace(opt_state):
    """The momentum tree inside optax's inject_hyperparams(chain(...))."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if hasattr(opt_state, "inner_state"):
        return _trace(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _trace(s)
            if found is not None:
                return found
    return None


B2 = "pool.linear2.bias"
SEED = 3  # a batch with no relu input at f32 noise (module docstring)


def _rel_close(got, want, tol, what):
    """max |got - want| within tol of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"


def _norm_close(got, want, tol, what):
    """||got - want|| within tol of ||want|| (2-norms over the tensor)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-12)
    assert err <= tol, f"{what}: error {err:.3g} of its norm > {tol}"


@pytest.mark.parametrize("fused", [True, False])
def test_two_train_steps_match_jax(fused):
    rng = np.random.default_rng(SEED)
    batches = [{"wav": rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(
                    np.float32),
                "label": rng.integers(0, NCLS, B).astype(np.int32)}
               for _ in range(2)]
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-4, final_lr=5e-5,
                 warm_up_epoch=1)
    m_kw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=3,
                initial_margin=0.0, final_margin=0.2)

    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=False,
                    fused_tail=fused)
    jproj = JArcMargin(EMB, NCLS)
    tx = j_opt(OPT_CONF)
    state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(0),
                             feat_dim=FEAT, embed_dim=EMB)
    jstep = jax.jit(j_make_train_step(
        jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
        jsched.MarginScheduler(**m_kw),
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
        aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

    model = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True, fused=fused)
    model.load_state_dict(from_jax_variables(
        {"params": state.params["model"],
         "batch_stats": state.batch_stats}), strict=True)
    proj = ArcMarginProduct(EMB, NCLS)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(np.array(
            state.params["projection"]["weight"])))
    before = {k: v.clone() for k, v in model.state_dict().items()}
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
                       f"step {i} {key}")
    assert step.step == 2
    assert float(jm["margin"]) > 0  # the second step ran with a margin

    want = from_jax_variables({"params": state.params["model"],
                               "batch_stats": state.batch_stats})
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 2, key
        elif key.endswith(("running_mean", "running_var")):
            _rel_close(got[key], value, 1e-4, key)
        elif key == B2:
            continue  # its gradient is zero up to noise: checked below
        else:
            _norm_close(got[key], value, 2e-3, key)
            _norm_close(got[key] - before[key], value - before[key], 3e-3,
                        f"update of {key}")
    _norm_close(proj.weight.detach(), state.params["projection"]["weight"],
                2e-3, "projection.weight")

    trace = _trace(state.opt_state)
    want_buf = from_jax_variables({"params": trace["model"]})
    for name, p in model.named_parameters():
        buf = opt.state[p]["momentum_buffer"]
        if name == B2:
            # b2 shifts a whole softmax column: its exact gradient is 0
            assert buf.abs().max().item() < 1e-4, name
            continue
        _norm_close(buf, want_buf[name], 3e-3, f"momentum {name}")
    _norm_close(opt.state[proj.weight]["momentum_buffer"],
                trace["projection"]["weight"], 3e-3, "momentum projection")


def test_spec_aug_and_dither_distributions():
    """The random streams are not JAX's, so the distributions are checked:
    the share of masked utterances is near spec_aug_prob (3 sigma), every
    mask's width lies in [1, max], and dither has the stated std."""
    gen = torch.Generator().manual_seed(0)
    cfg = AugConfig(spec_aug_prob=0.6, max_t=10, max_f=8)
    b, t, f = 4000, 50, 40
    out = spec_aug_batch(gen, torch.ones(b, t, f), cfg)
    zero = out == 0
    masked = zero.flatten(1).any(dim=1)
    share = masked.float().mean().item()
    assert abs(share - 0.6) < 3 * (0.6 * 0.4 / b) ** 0.5, share
    t_width = zero.all(dim=2).sum(dim=1)[masked]
    f_width = zero.all(dim=1).sum(dim=1)[masked]
    assert 1 <= int(t_width.min()) and int(t_width.max()) <= 10
    assert 1 <= int(f_width.min()) and int(f_width.max()) <= 8
    assert float(t_width.float().mean()) > 4  # not all width 1
    assert torch.equal(out[~masked], torch.ones_like(out[~masked]))
    noise = dither_wav(torch.zeros(64, 16000), 1.5, gen)
    assert abs(noise.std().item() - 1.5) < 0.01
    assert abs(noise.mean().item()) < 0.01
    with pytest.raises(ValueError, match="unknown spec_aug_args"):
        AugConfig.from_spec_aug_args({"max_w": 3})
    assert AugConfig.from_spec_aug_args({"prob": 0.3}).spec_aug_prob == 0.3


def _corpus(root, n_spk=3, n_utt=2, seconds=(0.9, 1.6), seed=0):
    """PCM16 wavs of noise, a jsonl raw list and utt2spk."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lines, u2s = [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            n = int(rng.uniform(*seconds) * 16000)
            path = os.path.join(root, f"{key}.wav")
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


def test_dataset_raw_matches_jax(tmp_path):
    """Both pipelines draw from numpy's generator, so keys, labels and the
    chunks themselves must match exactly over several epochs."""
    raw, _ = _corpus(str(tmp_path))
    spk2id = {f"spk{s}": s for s in range(3)}
    conf = {"num_frms": 50, "filter_args": {"min_num_frames": 20,
                                            "max_num_frames": 120},
            "shuffle_args": {"shuffle_size": 4}, "speed_perturb": True}
    want = JDataset("raw", raw, conf, spk2id, seed=5)
    got = SpeakerDataset("raw", raw, conf, spk2id, seed=5)
    assert got.num_classes() == want.num_classes() == 9
    jb, tb = want.batches(2), got.batches(2)
    labels = set()
    for _ in range(9):  # three epochs of 6 utterances
        w, g = next(jb), next(tb)
        assert g["key"] == w["key"]
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["wav"].shape == w["wav"].shape == (2, 49 * 160 + 400)
        np.testing.assert_array_equal(g["wav"], w["wav"])
        labels.update(g["label"].tolist())
    assert max(labels) >= 3  # speed perturb relabelled some utterances
    # `feat` is ported (tests/test_torch_data_aug.py); an unknown type raises
    with pytest.raises(ValueError, match="data_type"):
        SpeakerDataset("kaldi", raw, conf, spk2id)


def _tiny_config(tmp_path, raw, utt2spk):
    cfg = {
        "exp_dir": str(tmp_path / "exp"), "train_data": raw,
        "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 1, "seed": 3,
        "log_batch_interval": 1, "model": "ECAPA_TDNN",
        "model_args": {"channels": C, "feat_dim": FEAT, "embed_dim": EMB,
                       "global_context_att": True},
        "projection_args": {"project_type": "arc_margin"},
        "dataset_args": {"batch_size": 2, "num_frms": 40,
                         "fbank_args": {"num_mel_bins": FEAT},
                         "filter_args": {"min_num_frames": 20},
                         "speed_perturb": True, "spec_aug": True},
        "scheduler_args": {"initial_lr": 0.1, "final_lr": 0.01,
                           "warm_up_epoch": 0},
    }
    path = tmp_path / "conf.yaml"
    import yaml
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_trainer_cli_writes_a_checkpoint_the_extractor_loads(tmp_path):
    raw, utt2spk = _corpus(str(tmp_path / "data"))
    conf = _tiny_config(tmp_path, raw, utt2spk)
    step = train_cli.train(conf, device="cpu")
    assert step.step == 3  # 6 utterances, batch 2, one epoch
    models = tmp_path / "exp" / "models"
    assert (models / "model_0.pt").exists()
    assert os.readlink(models / "final_model.pt") == "model_0.pt"
    log = (tmp_path / "exp" / "train.log").read_text()
    assert "epoch 0 it 0/3 loss" in log and "epoch 0 it 2/3" in log
    configs = load_yaml(str(tmp_path / "exp" / "config.yaml"))
    assert configs["num_class"] == 9 and configs["epoch_iter"] == 3

    model = load_model_for_eval(configs, str(models / "final_model.pt"),
                                device="cpu")
    sd = torch.load(models / "model_0.pt", weights_only=True)
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd["state_dict"][key]), key
    embed = make_eval_embed_fn(model, FbankConfig(num_mel_bins=FEAT),
                               device="cpu")
    wav = np.random.default_rng(1).uniform(-0.3, 0.3, (1, 16000)).astype(
        np.float32)
    emb = embed({"wav": wav})
    assert emb.shape == (1, EMB) and torch.isfinite(emb).all()

    # resume: the checkpoint's epoch is done, so nothing is left to run
    step = train_cli.train(conf, [f"checkpoint={models / 'model_0.pt'}"],
                           device="cpu")
    assert step.step == 3


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    raw, utt2spk = _corpus(str(tmp_path / "data"), n_spk=2, n_utt=1)
    conf = _tiny_config(tmp_path, raw, utt2spk)
    # profile_args is ported (tests/test_torch_profiling.py), and so are
    # distributed_args and parallel_args (tests/test_torch_parallel.py):
    # distributed_args without the rendezvous address raises before any
    # rank waits, and a model axis must divide the ranks
    with pytest.raises(ValueError, match="coordinator"):
        train_cli.train(conf, ["distributed_args={num_processes: 2, "
                               "process_id: 0}"], device="cpu")
    with pytest.raises(ValueError, match="must divide the world size 1"):
        train_cli.train(conf, ["parallel_args={model: 2}"], device="cpu")
    # conv_dw_mode is ported (packed or native); any other mode raises
    with pytest.raises(ValueError, match="native|packed"):
        train_cli.train(conf, ["conv_dw_mode=fast"], device="cpu")
    # every head and every frontend of the JAX package is ported; a name
    # the JAX package does not take ("whisper": its frontend is
    # whisper_encoder) raises as its build_model does
    with pytest.raises(KeyError, match="unknown frontend whisper"):
        train_cli.train(conf, ["dataset_args.frontend=whisper"],
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.train(conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--config", conf])


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint reloads strictly into the model; the head is loaded by
    name, its rows cut or kept when the class count changed, and any
    other mismatch raises."""
    torch.manual_seed(0)
    model = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True)
    head = ArcMarginProduct(EMB, 9)
    path = str(tmp_path / "model_4.pt")
    ckpt.save_checkpoint(path, model, head)

    torch.manual_seed(1)
    model2 = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True)
    head2 = ArcMarginProduct(EMB, 9)
    ckpt.load_checkpoint(path, model2, head2)
    for key, value in model.state_dict().items():
        assert torch.equal(value, model2.state_dict()[key]), key
    assert torch.equal(head.weight, head2.weight)

    fewer = ArcMarginProduct(EMB, 3)   # e.g. the LM phase without perturb
    ckpt.load_checkpoint(path, model2, fewer)
    assert torch.equal(fewer.weight, head.weight[:3])
    more = ArcMarginProduct(EMB, 12)
    fresh = more.weight.detach().clone()
    ckpt.load_checkpoint(path, model2, more)
    assert torch.equal(more.weight[:9], head.weight)
    assert torch.equal(more.weight[9:], fresh[9:])
    with pytest.raises(ValueError, match="projection weight"):
        ckpt.load_checkpoint(path, model2, ArcMarginProduct(EMB + 1, 9))
    with pytest.raises(RuntimeError):  # strict model load
        ckpt.load_checkpoint(path, ECAPA_TDNN(C, FEAT, EMB), head2)

    assert ckpt.parse_start_epoch(path) == 5
    assert ckpt.parse_start_epoch(str(tmp_path / "preempt_model_4.pt")) == 4
    assert ckpt.parse_start_epoch(str(tmp_path / "final_model.pt")) == 0
    ckpt.save_checkpoint(str(tmp_path / "model_10.pt"), model)
    ckpt.save_checkpoint(str(tmp_path / "preempt_model_2.pt"), model)
    assert [os.path.basename(p) for p in ckpt.find_epoch_checkpoints(
        str(tmp_path))] == ["model_4.pt", "model_10.pt"]
