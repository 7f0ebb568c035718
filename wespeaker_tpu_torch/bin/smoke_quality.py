"""Quality smoke: does the port's trainer learn? On the card.

    python -m wespeaker_tpu_torch.bin.smoke_quality WORKDIR \
        [--method supervised|dino|moco|simclr] [--epochs N] [--n_spk N] \
        [--device cuda|cpu] [k=v trainer overrides]

The port's counterpart of scripts/smoke_quality_tpu.py (supervised) and
scripts/smoke_ssl_quality_tpu.py (dino, moco, simclr), as one CLI. It
writes a synthetic corpus of `n_spk` speakers (60) from fixed seeds, 8
training and 2 evaluation utterances of 3 s each: every speaker has a
fixed formant envelope, fundamental and spectral tilt, every utterance
its own f0 jitter, syllabic modulation and breath noise. The trials are
every same-speaker pair of evaluation utterances and ten times as many
random cross-speaker pairs. Then it drives the port's CLIs with
`python -m wespeaker_tpu_torch.bin.*`, each on `--device`: the trainer
(train, train_dino or train_contrastive), for the SSL methods
average_model --num 2 over the last epochs' teacher backbones, then
extract --batch_size 32 --bf16, score and compute_metrics. It prints one
JSON line {"method", "eer_percent", "minDCF", "n_speakers",
"train_wall_s", "extract_wall_s"}; chance is 50% EER. The supervised
method adds the back end (`back_end`): PLDA trained on the training
list's embeddings (plda_eer_percent), AS-Norm with them as cohort
(asnorm_eer_percent) and QMF calibration trained on calibration trials
over the training utterances (qmf_eer_percent), and back_end_wall_s. `--bucket_drift`
adds how far a padded bucket moves an embedding of the trained model
(bucket_drift).

The corpus, the trials and the configs are the JAX scripts': supervised
ECAPA_TDNN at 256 channels, embed 128, ASTP, ArcMargin, SGD, bf16 AMP,
batch 64 x 200 frames, 24 epochs of 3,840 samples; DINO, MoCo and SimCLR
ECAPA_TDNN_GLOB_c512 over the training list repeated 8 times (60 steps an
epoch), 80 epochs. One deliberate difference: `dataloader_args.num_workers`
is 0 where the JAX script has 2, since the port's trainer runs its data
pipeline in one process (a prefetch thread) and refuses more. `--epochs`
and `--n_spk` shorten a run; trailing k=v overrides go to the trainer
(a narrow model for a test on the CPU). The JAX script's
`--epochs_per_proc` (DINO in fresh processes, a workaround for a host
memory leak of the TPU client) has no counterpart: one process holds an
80-epoch DINO run on the card in 15 minutes.
"""

import argparse
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import time
import wave

import numpy as np

N_SPK = 60
N_TRAIN_UTT = 8
N_EVAL_UTT = 2
SECONDS = 3.0
SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth_utterance(rng, formants, bandwidths, f0_base, tilt):
    """Harmonic source with a speaker-specific formant envelope."""
    t = np.arange(int(SECONDS * SR)) / SR
    f0 = f0_base * (1.0 + 0.04 * rng.standard_normal()
                    + 0.02 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = np.zeros_like(t)
    for h in range(1, 40):
        freq = h * f0_base
        if freq > SR / 2 - 200:
            break
        # formant envelope: sum of resonances
        gain = sum(b ** 2 / ((freq - fm) ** 2 + b ** 2)
                   for fm, b in zip(formants, bandwidths))
        gain *= (freq / 500.0) ** tilt  # speaker-specific spectral tilt
        sig += gain * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    # syllabic amplitude modulation + breath noise
    am = 0.55 + 0.45 * np.clip(np.sin(
        2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)), 0, None)
    sig = sig * am / (np.max(np.abs(sig)) + 1e-9)
    sig = 0.3 * sig + 0.005 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


def write_pcm16(path, sig):
    """PCM16 mono at SR, samples truncated toward zero from sig * 32767."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


def make_corpus(root, n_spk=N_SPK):
    """wav/, train.list and eval.list (jsonl {"key", "wav", "spk"}),
    utt2spk (training utterances) and trials under `root`."""
    rng = np.random.default_rng(0)
    wav_dir = os.path.join(root, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    train_lines, eval_lines, u2s = [], [], []
    for s in range(n_spk):
        formants = np.sort(rng.uniform([250, 800, 1800, 2800],
                                       [750, 1700, 2700, 3600]))
        bandwidths = rng.uniform(60, 140, 4)
        f0_base = rng.uniform(80, 260)
        tilt = rng.uniform(-0.8, 0.8)
        for u in range(N_TRAIN_UTT + N_EVAL_UTT):
            key = f"spk{s:03d}_utt{u}"
            path = os.path.join(wav_dir, key + ".wav")
            write_pcm16(path, synth_utterance(rng, formants, bandwidths,
                                              f0_base, tilt))
            line = json.dumps({"key": key, "wav": path, "spk": f"spk{s:03d}"})
            if u < N_TRAIN_UTT:
                train_lines.append(line)
                u2s.append(f"{key} spk{s:03d}")
            else:
                eval_lines.append(line)
    for name, rows in (("train.list", train_lines),
                       ("eval.list", eval_lines), ("utt2spk", u2s)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")

    # trials: all same-speaker eval pairs + 10x random cross pairs
    rng2 = np.random.default_rng(1)
    keys = [json.loads(ln)["key"] for ln in eval_lines]
    spk_of = {k: k.split("_")[0] for k in keys}
    trials = []
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            if spk_of[a] == spk_of[b]:
                trials.append(f"{a} {b} target")
    n_non = 10 * len(trials)
    while n_non > 0:
        a, b = rng2.choice(keys, 2, replace=False)
        if spk_of[a] != spk_of[b]:
            trials.append(f"{a} {b} nontarget")
            n_non -= 1
    with open(os.path.join(root, "trials"), "w") as f:
        f.write("\n".join(trials) + "\n")


SUPERVISED_CONFIG = """
exp_dir: {root}/exp
data_type: raw
train_data: {root}/train.list
utt2spk: {root}/utt2spk
num_epochs: 24
samples_per_epoch: 3840    # the 480-utt corpus repeats ~8x per epoch
log_batch_interval: 30
enable_amp: true
dataset_args:
  batch_size: 64
  num_frms: 200
  shuffle: true
  shuffle_args:
    shuffle_size: 512
  fbank_args:
    num_mel_bins: 80
    frame_shift: 10
    frame_length: 25
    dither: 1.0
  spec_aug: true
dataloader_args:
  num_workers: 0
model: ECAPA_TDNN
model_args:
  feat_dim: 80
  embed_dim: 128
  channels: 256
  pooling_func: ASTP
projection_args:
  project_type: arc_margin
  scale: 32.0
  easy_margin: false
optimizer: SGD
optimizer_args:
  momentum: 0.9
  nesterov: true
  weight_decay: 0.0001
scheduler: ExponentialDecrease
scheduler_args:
  initial_lr: 0.1
  final_lr: 0.001
  warm_up_epoch: 2
margin_scheduler_args:
  initial_margin: 0.0
  final_margin: 0.2
  increase_start_epoch: 6
  fix_start_epoch: 14
  increase_type: exp
"""

_SSL_DATA = """
seed: 42
data_type: raw
train_data: {root}/train8x.list
utt2spk: {root}/utt2spk
num_epochs: 80
log_batch_interval: 20
enable_amp: true
dataset_args:
  batch_size: 64
  shuffle: true
  shuffle_args:
    shuffle_size: 512
  speed_perturb: false
  aug_prob: 0.0
  fbank_args:
    num_mel_bins: 80
    frame_shift: 10
    frame_length: 25
    dither: 1.0
  filter_args:
    min_num_frames: 100
    max_num_frames: 400
model: ECAPA_TDNN_GLOB_c512
model_args:
  feat_dim: 80
  embed_dim: 128
  pooling_func: ASTP
"""

DINO_CONFIG = "exp_dir: {root}/exp_dino" + _SSL_DATA + """
dino_args:
  head_out_dim: 8192
  head_hidden_dim: 1024
  bottleneck_dim: 128
  head_use_bn: true
  global_chunk_num: 2
  local_chunk_num: 4
  global_chunk_sec: 2.0
  local_chunk_sec: 1.0
  base_lr: 0.2
  final_lr: 0.00005
  warmup_epochs: 8
  warmup_teacher_temp: 0.04
  teacher_temp: 0.07
  momentum_teacher: 0.996
  clip_grad: 3.0
  freeze_last_layer_epochs: 1
"""

CONTRASTIVE_CONFIG = ("exp_dir: {root}/exp_{method}\nssl_method: {method}"
                      + _SSL_DATA + """
ssl_args:
  chunk_sec: 2.0
  queue_size: 4096
  temperature: 0.07
  base_lr: 0.1
""")

TRAINERS = {"supervised": "train", "dino": "train_dino",
            "moco": "train_contrastive", "simclr": "train_contrastive"}


def run(cmd, capture=False):
    """`python -m wespeaker_tpu_torch.bin.<cmd[0]> cmd[1:]` with this
    checkout first on the path; raises if it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    full = [sys.executable, "-m", f"wespeaker_tpu_torch.bin.{cmd[0]}",
            *cmd[1:]]
    print("+", " ".join(full), file=sys.stderr, flush=True)
    return subprocess.run(full, check=True, env=env, capture_output=capture,
                          text=True).stdout


def write_config(root, method):
    """The method's YAML under root (SSL: also train8x.list); returns
    (config path, exp dir)."""
    if method == "supervised":
        text, exp = SUPERVISED_CONFIG.format(root=root), "exp"
    else:
        # an SSL epoch is len(train_data) // batch steps: the list 8 times
        # over gives 60 steps an epoch, the supervised smoke's 3,840
        with open(os.path.join(root, "train.list")) as f:
            lines = f.read().strip().splitlines()
        with open(os.path.join(root, "train8x.list"), "w") as f:
            f.write("\n".join(lines * 8) + "\n")
        exp = f"exp_{method}"
        text = (DINO_CONFIG.format(root=root) if method == "dino" else
                CONTRASTIVE_CONFIG.format(root=root, method=method))
    path = os.path.join(root, f"{method}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path, os.path.join(root, exp)


def parse_metrics(out):
    """(EER %, minDCF) from compute_metrics' printed lines."""
    eer = mindcf = None
    for line in out.splitlines():
        if line.startswith("EER"):
            eer = float(line.split("=")[1].replace("%", ""))
        elif line.startswith("minDCF"):
            mindcf = float(line.split("=")[1])
    return eer, mindcf


def bucket_drift(config, ckpt, eval_list, device="cuda", keep=0.75):
    """How far a padded bucket moves an embedding on the trained model:
    each evaluation utterance cut to `keep` of its length is embedded
    alone (batch=1) and zero-padded back to its full length with a sample
    mask, as a bucket of the linear 1 s grid pads it; f32, TF32 off.
    Returns (lowest, mean) cosine between the two. The mask gates CMVN and
    the pooling, not the convolutions, as in the JAX package."""
    import torch

    from wespeaker_tpu_torch.bin.extract import (matmul_precision,
                                                 iter_wavs_from_list,
                                                 load_model_for_eval)
    from wespeaker_tpu_torch.frontend.fbank import FbankConfig
    from wespeaker_tpu_torch.train import make_eval_embed_fn
    from wespeaker_tpu_torch.utils.config import load_yaml

    configs = load_yaml(config)
    embed = make_eval_embed_fn(
        load_model_for_eval(configs, ckpt, device=device),
        FbankConfig(num_mel_bins=configs["model_args"]["feat_dim"]),
        device=device)
    cos = []
    with matmul_precision("float32"):
        for _, wav in iter_wavs_from_list(eval_list):
            n = int(len(wav) * keep)
            padded = np.zeros((1, len(wav)), np.float32)
            padded[0, :n] = wav[:n]
            mask = (np.arange(len(wav)) < n)[None].astype(np.float32)
            a = embed({"wav": padded[:, :n]}).double()
            b = embed({"wav": padded, "mask": mask}).double()
            cos.append(float(torch.nn.functional.cosine_similarity(a, b)))
    return min(cos), float(np.mean(cos))


def smoke(workdir, method="supervised", epochs=None, n_spk=N_SPK,
          device="cuda", overrides=(), drift=False):
    """Corpus, training, extraction, scoring and metrics; returns the
    result dict that main() prints."""
    root = os.path.abspath(workdir)
    os.makedirs(root, exist_ok=True)
    make_corpus(root, n_spk)
    cfg, exp = write_config(root, method)
    dev = ["--device", device]
    over = list(overrides) + ([f"num_epochs={epochs}"] if epochs else [])
    t0 = time.time()
    run([TRAINERS[method], "--config", cfg, *dev, *over])
    train_s = time.time() - t0

    models = os.path.join(exp, "models")
    if method == "supervised":
        ckpt = os.path.join(models, "final_model.pt")
    else:
        # the recipe's stage 3: average the last teacher backbones
        ckpt = os.path.join(models, "avg_model.pt")
        run(["average_model", "--dst_model", ckpt, "--src_path", models,
             "--num", "2"])
    emb = os.path.join(root, f"eval_emb_{method}")
    t0 = time.time()
    run(["extract", "--config", os.path.join(exp, "config.yaml"),
         "--checkpoint", ckpt, "--data_list",
         os.path.join(root, "eval.list"), "--out_prefix", emb,
         "--batch_size", "32", "--bf16", *dev])
    extract_s = time.time() - t0
    run(["score", "--exp_dir", exp, "--eval_scp_path", emb + ".scp", *dev,
         os.path.join(root, "trials")])
    out = run(["compute_metrics", "--p_target", "0.01",
               os.path.join(exp, "scores", "trials.score")], capture=True)
    print(out, file=sys.stderr)
    eer, mindcf = parse_metrics(out)
    result = {"method": method, "eer_percent": eer, "minDCF": mindcf,
              "n_speakers": n_spk, "train_wall_s": round(train_s, 1),
              "extract_wall_s": round(extract_s, 1)}
    if method == "supervised":
        result.update(back_end(root, exp, ckpt, emb, dev))
    if drift:
        low, mean = bucket_drift(os.path.join(exp, "config.yaml"), ckpt,
                                 os.path.join(root, "eval.list"), device)
        result.update(bucket_drift_min_cos=low, bucket_drift_mean_cos=mean)
    return result


def cli(name, args):
    """`wespeaker_tpu_torch.bin.<name>.main(args)` in this process; returns
    what it printed."""
    print("+", name, " ".join(args), file=sys.stderr, flush=True)
    module = importlib.import_module(f"wespeaker_tpu_torch.bin.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(list(args))
    return out.getvalue()


def back_end(root, exp, ckpt, eval_emb, dev):
    """The supervised smoke's back end, as the recipes run it, in this
    process through the CLIs' main(): the training list extracted as the
    eval list is, PLDA trained on the training
    embeddings (plda_tools train) and scored on the evaluation trials;
    AS-Norm (score_norm, top 100) with the training embeddings as cohort;
    QMF (score_calibration, with prep_data wav2dur's durations) trained on
    prep_data calibration_trial's trials over the training utterances and
    applied to the evaluation trials. Returns {"plda_eer_percent",
    "asnorm_eer_percent", "qmf_eer_percent", "back_end_wall_s"}."""
    from wespeaker_tpu_torch.utils.config import load_yaml

    t0 = time.time()
    config = os.path.join(exp, "config.yaml")
    train_emb = os.path.join(root, "train_emb_supervised")
    cli("extract", ["--config", config, "--checkpoint", ckpt, "--data_list",
                    os.path.join(root, "train.list"), "--out_prefix",
                    train_emb, "--batch_size", "32", "--bf16", *dev])
    embed_dim = str(load_yaml(config)["model_args"]["embed_dim"])
    scores = os.path.join(exp, "scores")
    entries = []
    for name in ("train.list", "eval.list"):
        with open(os.path.join(root, name)) as f:
            entries += [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(root, "wav.scp"), "w") as f:
        f.write("".join(f"{o['key']} {o['wav']}\n" for o in entries))
    with open(os.path.join(root, "utt2utt"), "w") as f:
        f.write("".join(f"{o['key']} {o['key']}\n" for o in entries))
    plda = os.path.join(exp, "plda.h5")
    cli("plda_tools", ["train", "--scp_path", train_emb + ".scp",
                       "--utt2spk", os.path.join(root, "utt2spk"),
                       "--model_path", plda, "--embed_dim", embed_dim, *dev])
    cli("plda_tools", ["eval", "--enroll_scp_path", eval_emb + ".scp",
                       "--enroll_utt2spk", os.path.join(root, "utt2utt"),
                       "--test_scp_path", eval_emb + ".scp", "--trials",
                       os.path.join(root, "trials"), "--score_path",
                       os.path.join(scores, "plda.score"), "--model_path",
                       plda, *dev])
    dur, cal_trials = (os.path.join(root, "utt2dur"),
                       os.path.join(root, "cal_trials"))
    cli("prep_data", ["wav2dur", "--wav_scp", os.path.join(root, "wav.scp"),
                      "--out", dur])
    cli("prep_data", ["calibration_trial", "--utt2spk",
                      os.path.join(root, "utt2spk"), "--out_trials",
                      cal_trials])
    cli("score", ["--exp_dir", exp, "--eval_scp_path", train_emb + ".scp",
                  *dev, cal_trials])
    for name, emb in (("cal_trials", train_emb), ("trials", eval_emb)):
        cli("score_norm", ["--score_norm_method", "asnorm", "--top_n", "100",
                           "--trial_score_file",
                           os.path.join(scores, name + ".score"),
                           "--score_norm_file",
                           os.path.join(scores, name + ".norm"),
                           "--cohort_emb_scp", train_emb + ".scp",
                           "--eval_emb_scp", emb + ".scp", *dev])
    qmf = os.path.join(exp, "qmf.npz")
    cli("score_calibration", ["train", "--score_norm_file",
                              os.path.join(scores, "cal_trials.norm"),
                              "--save_model_path", qmf, "--wav_dur_scp", dur,
                              *dev])
    cli("score_calibration", ["infer", "--score_norm_file",
                              os.path.join(scores, "trials.norm"),
                              "--model_path", qmf, "--out_score_file",
                              os.path.join(scores, "trials.qmf"),
                              "--wav_dur_scp", dur, *dev])
    out = {}
    for key, name in (("plda", "plda.score"), ("asnorm", "trials.norm"),
                      ("qmf", "trials.qmf")):
        text = cli("compute_metrics", ["--p_target", "0.01",
                                       os.path.join(scores, name)])
        out[f"{key}_eer_percent"] = parse_metrics(text)[0]
    out["back_end_wall_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--method", default="supervised", choices=list(TRAINERS))
    ap.add_argument("--epochs", type=int, default=None,
                    help="num_epochs (24 supervised, 80 SSL)")
    ap.add_argument("--n_spk", type=int, default=N_SPK)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--bucket_drift", action="store_true",
                    help="also report bucket_drift_min_cos / _mean_cos: "
                         "utterances cut to 3/4 embedded alone and padded "
                         "back to their bucket with a mask")
    ap.add_argument("overrides", nargs="*",
                    help="k=v overrides for the trainer")
    # intermixed: the overrides may follow the options
    args = ap.parse_intermixed_args(argv)
    print(json.dumps(smoke(args.workdir, args.method, args.epochs,
                           args.n_spk, args.device, args.overrides,
                           args.bucket_drift)))


if __name__ == "__main__":
    main()
