"""Offline diarization CLI: wav.scp (+ oracle SAD rttm) -> RTTM (+ DER), on
the card.

    python -m wespeaker_tpu_torch.bin.diarize --config exp/config.yaml \
        --checkpoint exp/models/avg_model.pt|.ckpt --wav_scp wav.scp \
        --out_rttm out.rttm [--sad_rttm sad.rttm | --sad_model vad.jit] \
        [--clusterer spectral|umap] [--num_spks N] [--ref_rttm ref.rttm] \
        [--batch_size 64] [--bf16] [--data_parallel [--devices LIST]] \
        [--device cuda|cpu] [k=v overrides]

Counterpart of wespeaker_tpu/bin/diarize.py: the staged voxconverse
recipe (examples/voxconverse/v2/run.sh stages 2-8) as one pass per
recording: SAD -> per-segment fbank -> sliding-window embeddings ->
clustering -> merged RTTM -> optional DER against a reference RTTM. The
checkpoint is a port `.pt` or the JAX package's `.ckpt`
(bin/extract.py's load_model_for_eval). --bf16 runs the activations in
bfloat16 (utils/eval_device.py), through the model's kernels.
--data_parallel splits each window batch over one model replica a card
(or the `--devices` given), as bin/extract.py does; the RTTM is the one
replica's.
"""

import argparse

from wespeaker_tpu_torch.bin.extract import fbank_config, load_model_for_eval
from wespeaker_tpu_torch.train.composite import frontend_type
from wespeaker_tpu_torch.data.pipeline import resample_array
from wespeaker_tpu_torch.data.wav_io import read_wav
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.diar import rttm as rttm_mod
from wespeaker_tpu_torch.diar.pipeline import (CLUSTERERS, diarize_wav,
                                               model_embedder)
from wespeaker_tpu_torch.diar.vad import TorchJitVad, system_sad
from wespeaker_tpu_torch.utils.config import parse_config_or_kwargs
from wespeaker_tpu_torch.utils.eval_device import (prepare_eval_placement,
                                                   replica_devices,
                                                   replicate, round_batch,
                                                   split_over)


def _on(embed_batch, device):
    """embed_batch taking its windows on `device`."""
    return lambda banks: embed_batch(banks.to(device))


def diarize(config, checkpoint_path, wav_scp, out_rttm, sad_rttm=None,
            clusterer="spectral", num_spks=None, ref_rttm=None,
            batch_size=64, bf16=False, data_parallel=False,
            sad_model=None, sad_threshold=0.18,
            overrides=None, device: DeviceLike = None, devices=None,
            **kwargs):
    """Diarize every recording of `wav_scp` into `out_rttm`; returns
    (out_rttm, DER against ref_rttm or None). Runs on the card unless the
    caller passes device="cpu"."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    if frontend_type(configs) != "fbank":
        raise ValueError("diarization windows are fbank; the "
                         f"{frontend_type(configs)} frontend is not")
    dev = resolve_device(device)
    model = load_model_for_eval(configs, checkpoint_path, device=dev)
    model, compute_dtype = prepare_eval_placement(model, bf16, device=dev)
    devices = replica_devices(data_parallel, dev, devices)
    batch_size = round_batch(batch_size, len(devices))
    embed_batch = split_over([
        _on(model_embedder(replica, compute_dtype), d)
        for replica, d in zip(replicate(model, devices), devices)])
    fbank_cfg = fbank_config(configs)
    rate = fbank_cfg.sample_rate

    oracle = rttm_mod.oracle_sad(sad_rttm) if sad_rttm else {}
    sad_prob_fn = None
    sad_window = int(rate * 0.032)  # silero chunk: 512 @ 16 kHz, 256 @ 8 kHz
    if sad_model:
        # load the torch.jit VAD once, not per recording
        sad_prob_fn = TorchJitVad(sad_model, sad_window).speech_probs
    hyp = {}
    with open(out_rttm, "w") as fout, open(wav_scp) as f:
        for line in f:
            utt, path = line.split()
            wav, sr = read_wav(path)
            if wav.ndim > 1:
                wav = wav[0]
            if sr != rate:
                wav, sr = resample_array(wav, sr, rate), rate
            sad = oracle.get(utt) if sad_rttm else None
            if sad is None and sad_prob_fn is not None:
                # silero post-processing over a torch.jit prob model
                # (make_system_sad.py:44-62, threshold 0.18)
                sad = system_sad(wav, sr, prob_fn=sad_prob_fn,
                                 threshold=sad_threshold,
                                 window_samples=sad_window)
            merged, _ = diarize_wav(
                utt, wav, sr, embed_batch, sad_segments=sad,
                fbank_cfg=fbank_cfg, clusterer=clusterer,
                num_spks=num_spks, batch_size=batch_size, device=dev)
            rttm_mod.write_rttm(merged, fout)
            hyp[utt] = [(b, e, lab) for (_, b, e, lab) in merged]
    if ref_rttm:
        ref = rttm_mod.read_rttm(ref_rttm)
        der = rttm_mod.compute_der(ref, hyp)
        print(f"DER = {der * 100:.2f} %")
        return out_rttm, der
    return out_rttm, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--wav_scp", required=True)
    ap.add_argument("--out_rttm", required=True)
    ap.add_argument("--sad_rttm", default=None,
                    help="oracle SAD source rttm; energy VAD if omitted")
    ap.add_argument("--sad_model", default=None,
                    help="silero-style torch.jit VAD model file for system "
                         "SAD (host CPU); energy VAD if omitted")
    ap.add_argument("--sad_threshold", type=float, default=0.18,
                    help="speech probability trigger (the reference "
                         "diarization recipe uses 0.18)")
    ap.add_argument("--clusterer", default="spectral", choices=CLUSTERERS)
    ap.add_argument("--num_spks", type=int, default=None)
    ap.add_argument("--ref_rttm", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 activations (parameters stay f32, cast per "
                         "call)")
    ap.add_argument("--devices", default=None,
                    help="with --data_parallel, the replicas' devices, "
                         "comma-separated (one may repeat)")
    ap.add_argument("--data_parallel", action="store_true",
                    help="split each window batch over one replica a card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    return diarize(args.config, args.checkpoint, args.wav_scp, args.out_rttm,
                   args.sad_rttm, args.clusterer, args.num_spks,
                   args.ref_rttm, batch_size=args.batch_size, bf16=args.bf16,
                   data_parallel=args.data_parallel,
                   devices=args.devices.split(",") if args.devices else None,
                   sad_model=args.sad_model,
                   sad_threshold=args.sad_threshold,
                   overrides=args.overrides, device=args.device)


if __name__ == "__main__":
    main()
