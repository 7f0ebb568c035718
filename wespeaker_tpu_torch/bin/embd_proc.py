"""Embedding-processing chain CLIs: prep, apply and update.

    python -m wespeaker_tpu_torch.bin.embd_proc prep --chain "mean-subtract \
        --scp a.scp | length-norm | lda --scp t.scp --utt2spk u2s --dim 100 \
        | length-norm" --out embd_proc.pkl [--device cuda|cpu]
    python -m wespeaker_tpu_torch.bin.embd_proc apply --proc embd_proc.pkl \
        --in_scp in.scp --out_prefix out/emb_proc [--device cuda|cpu]
    python -m wespeaker_tpu_torch.bin.embd_proc update --proc embd_proc.pkl \
        --link_no 0 --new_link "mean-subtract --scp b.scp" --out new.pkl \
        [--device cuda|cpu]

Counterpart of wespeaker_tpu/bin/embd_proc.py (upstream
wespeaker/bin/{prep,apply,update}_embd_proc.py). The chain is estimated
and applied on the host in f64, as in the JAX package; `--device` is
resolved as every entry point's is (the card unless "cpu"). The chain
file is a pickle of the links as the JAX package writes it, read through
a restricted unpickler (backend/embedding_processing.py), so either
package reads the other's; the `.npz` archive of earlier versions of the
port still loads. apply writes `<out_prefix>.ark/.scp` in f32.
"""

import argparse

import numpy as np

from wespeaker_tpu_torch.backend.embedding_processing import \
    EmbeddingProcessingChain
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp, write_vec_ark_scp


def prep(chain_string, out_path, device: DeviceLike = None):
    resolve_device(device)
    EmbeddingProcessingChain(chain_string).save(out_path)
    return out_path


def apply(proc_path, in_scp, out_prefix, device: DeviceLike = None):
    resolve_device(device)
    chain = EmbeddingProcessingChain().load(proc_path)

    def items():
        for key, vec in read_vec_scp(in_scp):
            yield key, chain(vec[None])[0].astype(np.float32)

    return write_vec_ark_scp(out_prefix, items())


def update(proc_path, link_no, new_link, out_path,
           device: DeviceLike = None):
    resolve_device(device)
    chain = EmbeddingProcessingChain().load(proc_path)
    chain.update_link(int(link_no), new_link)
    chain.save(out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prep")
    p.add_argument("--chain", required=True)
    p.add_argument("--out", required=True)
    a = sub.add_parser("apply")
    a.add_argument("--proc", required=True)
    a.add_argument("--in_scp", required=True)
    a.add_argument("--out_prefix", required=True)
    u = sub.add_parser("update")
    u.add_argument("--proc", required=True)
    u.add_argument("--link_no", required=True)
    u.add_argument("--new_link", required=True)
    u.add_argument("--out", required=True)
    for s in (p, a, u):
        s.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "prep":
        prep(args.chain, args.out, device=args.device)
    elif args.cmd == "apply":
        apply(args.proc, args.in_scp, args.out_prefix, device=args.device)
    else:
        update(args.proc, args.link_no, args.new_link, args.out,
               device=args.device)


if __name__ == "__main__":
    main()
