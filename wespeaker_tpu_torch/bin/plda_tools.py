"""PLDA CLIs: train, adapt and eval, the scoring on the card.

    python -m wespeaker_tpu_torch.bin.plda_tools train --scp_path train.scp \
        --utt2spk utt2spk --model_path plda.h5 --embed_dim 256 \
        [--num_iters 5] [--device cuda|cpu]
    python -m wespeaker_tpu_torch.bin.plda_tools adapt --model_path plda.h5 \
        --adapt_scp_path adapt.scp --out_model plda_adapt.h5 \
        [--ac_scale 0.5] [--wc_scale 0.5] [--device cuda|cpu]
    python -m wespeaker_tpu_torch.bin.plda_tools eval \
        --enroll_scp_path enroll.scp --enroll_utt2spk utt2spk \
        --test_scp_path test.scp --trials trials --score_path plda.score \
        --model_path plda.h5 [--from_kaldi] [--indomain_scp mean.scp] \
        [--device cuda|cpu]

Counterpart of wespeaker_tpu/bin/plda_tools.py (upstream
wespeaker/bin/{train,eval,adapt}_plda.py). Training and adaptation run
on the host in f64 (backend/plda.py); eval's log-likelihood ratios run
on `--device`. The model file is HDF5 in the layout the JAX package's
h5py writes (utils/hdf5.py), so either package reads the other's; eval
also reads the `.npz` archive of earlier versions of the port, and with
--from_kaldi a Kaldi binary `<Plda>`. eval writes `enroll
test score label` lines and, when every trial has a label, prints
`PLDA EER = … % minDCF = …`.
"""

import argparse

import numpy as np

from wespeaker_tpu_torch.backend.metrics import (compute_metrics,
                                                 labels_from_strings)
from wespeaker_tpu_torch.backend.plda import TwoCovPLDA
from wespeaker_tpu_torch.backend.scoring import read_trials
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.utils.kaldi_io import (read_spk2emb,
                                                read_vec_scp_dict)


def train_plda(scp_path, utt2spk, model_path, embed_dim, num_iters=5,
               normalize_length=True, subtract_train_set_mean=False,
               device: DeviceLike = None):
    resolve_device(device)
    plda = TwoCovPLDA(dim=embed_dim, normalize_length=normalize_length,
                      subtract_train_set_mean=subtract_train_set_mean)
    plda.train(read_spk2emb(scp_path, utt2spk), num_iters)
    plda.save(model_path)
    return model_path


def eval_plda(enroll_scp, enroll_utt2spk, test_scp, trials_path, score_file,
              model_path, from_kaldi=False, indomain_scp=None,
              device: DeviceLike = None):
    dev = resolve_device(device)
    plda = (TwoCovPLDA.load_kaldi(model_path) if from_kaldi
            else TwoCovPLDA.load(model_path))
    enroll = read_spk2emb(enroll_scp, enroll_utt2spk)
    test = read_vec_scp_dict(test_scp)
    mean_vec = None
    if indomain_scp:
        vals = list(read_vec_scp_dict(indomain_scp).values())
        mean_vec = np.vstack(vals).mean(0)
    pairs, labels = read_trials(trials_path)
    scores = plda.score_trials(enroll, test, pairs, mean_vec=mean_vec,
                               device=dev)
    with open(score_file, "w") as f:
        for (a, b), s, lab in zip(pairs, scores, labels):
            f.write(f"{a} {b} {s:.5f} {lab}\n")
    if all(labels):
        y = labels_from_strings(labels)
        e, _, dcf = compute_metrics(np.asarray(scores), y)
        print(f"PLDA EER = {e:.3f}% minDCF = {dcf:.3f}")
    return score_file


def adapt_plda(model_path, adapt_scp, out_model, ac_scale=0.5, wc_scale=0.5,
               device: DeviceLike = None):
    resolve_device(device)
    plda = TwoCovPLDA.load(model_path)
    data = np.vstack(list(read_vec_scp_dict(adapt_scp).values()))
    plda.adapt(data, ac_scale, wc_scale).save(out_model)
    return out_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--scp_path", required=True)
    t.add_argument("--utt2spk", required=True)
    t.add_argument("--model_path", required=True)
    t.add_argument("--embed_dim", type=int, required=True)
    t.add_argument("--num_iters", type=int, default=5)
    e = sub.add_parser("eval")
    e.add_argument("--enroll_scp_path", required=True)
    e.add_argument("--enroll_utt2spk", required=True)
    e.add_argument("--test_scp_path", required=True)
    e.add_argument("--trials", required=True)
    e.add_argument("--score_path", required=True)
    e.add_argument("--model_path", required=True)
    e.add_argument("--from_kaldi", action="store_true")
    e.add_argument("--indomain_scp", default=None)
    a = sub.add_parser("adapt")
    a.add_argument("--model_path", required=True)
    a.add_argument("--adapt_scp_path", required=True)
    a.add_argument("--out_model", required=True)
    a.add_argument("--ac_scale", type=float, default=0.5)
    a.add_argument("--wc_scale", type=float, default=0.5)
    for p in (t, e, a):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "train":
        train_plda(args.scp_path, args.utt2spk, args.model_path,
                   args.embed_dim, args.num_iters, device=args.device)
    elif args.cmd == "eval":
        eval_plda(args.enroll_scp_path, args.enroll_utt2spk,
                  args.test_scp_path, args.trials, args.score_path,
                  args.model_path, args.from_kaldi, args.indomain_scp,
                  device=args.device)
    else:
        adapt_plda(args.model_path, args.adapt_scp_path, args.out_model,
                   args.ac_scale, args.wc_scale, device=args.device)


if __name__ == "__main__":
    main()
