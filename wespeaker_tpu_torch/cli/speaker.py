"""Product API: one-stop Speaker object and its command line, on the card.

    python -m wespeaker_tpu_torch.cli.speaker -p MODEL_DIR \
        -t embedding|embedding_kaldi|similarity|diarization|diarization_list \
        [--audio_file a.wav] [--audio_file2 b.wav] [--wav_scp wav.scp] \
        [--output_file out] [--device cuda|cpu] [--diar_* knobs]

Counterpart of wespeaker_tpu/cli/speaker.py (upstream
wespeaker/cli/speaker.py:39-301): load_model() /
Speaker.{extract_embedding, extract_embedding_list, compute_similarity,
register, recognize, diarize, diarize_list} with kaldi-style outputs.

A model directory holds config.yaml and a checkpoint: avg_model.ckpt,
final_model.ckpt or model.ckpt (the JAX package's msgpack), else the
first `.pt` by name (a port or upstream state_dict, or a file the port's
trainer wrote). Local directories only: the JAX package's hub
(cli/hub.py) downloads published models and is not ported. Runs on the
card unless the caller passes device="cpu".
"""

import argparse
import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from wespeaker_tpu_torch.bin.extract import load_model_for_eval
from wespeaker_tpu_torch.data.pipeline import resample_array
from wespeaker_tpu_torch.data.wav_io import read_wav
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.diar.pipeline import (diarize_wav, embed_windows,
                                               model_embedder)
from wespeaker_tpu_torch.diar.rttm import RTTM_LINE
from wespeaker_tpu_torch.diar.vad import energy_vad
from wespeaker_tpu_torch.frontend.fbank import FbankConfig, compute_fbank
from wespeaker_tpu_torch.train.composite import frontend_type
from wespeaker_tpu_torch.utils.config import load_yaml

CKPT_NAMES = ("avg_model.ckpt", "final_model.ckpt", "model.ckpt")


def model_checkpoint(model_dir: str) -> str:
    for name in CKPT_NAMES:
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return path
    pts = sorted(f for f in os.listdir(model_dir) if f.endswith(".pt"))
    if not pts:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    return os.path.join(model_dir, pts[0])


class Speaker:
    def __init__(self, model_dir: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        configs = load_yaml(os.path.join(model_dir, "config.yaml"))
        if frontend_type(configs) != "fbank":
            raise ValueError("Speaker computes fbank; the "
                             f"{frontend_type(configs)} frontend is not")
        self.configs = configs
        self.model = load_model_for_eval(configs,
                                         model_checkpoint(model_dir),
                                         self.device)
        self._embed_batch = model_embedder(self.model)
        feat_dim = configs["model_args"].get("feat_dim", 80)
        self.resample_rate = 16000
        self.apply_vad = False
        self.wavform_norm = False
        self.window_type = configs.get("window_type", "hamming")
        self.feat_dim = feat_dim
        self.table: Dict[str, np.ndarray] = {}
        self.diar_num_spks = None
        self.diar_min_num_spks = 1
        self.diar_max_num_spks = 20
        self.diar_min_duration = 0.255
        self.diar_window_secs = 1.5
        self.diar_period_secs = 0.75
        self.diar_frame_shift = 10
        self.diar_batch_size = 32
        self.diar_subseg_cmn = True

    # ---- configuration (mirrors the reference setters) ----
    def set_wavform_norm(self, v: bool):
        self.wavform_norm = v

    def set_resample_rate(self, r: int):
        self.resample_rate = r

    def set_vad(self, v: bool):
        self.apply_vad = v

    def set_window_type(self, w: str):
        self.window_type = w

    def set_diarization_params(self, num_spks=None, min_num_spks=1,
                               max_num_spks=20, min_duration: float = 0.255,
                               window_secs: float = 1.5,
                               period_secs: float = 0.75,
                               frame_shift: int = 10, batch_size: int = 32,
                               subseg_cmn: bool = True):
        """Superset of the reference cli/speaker.py:82-96 knobs."""
        self.diar_num_spks = num_spks
        self.diar_min_num_spks = min_num_spks
        self.diar_max_num_spks = max_num_spks
        self.diar_min_duration = min_duration
        self.diar_window_secs = window_secs
        self.diar_period_secs = period_secs
        self.diar_frame_shift = frame_shift
        self.diar_batch_size = batch_size
        self.diar_subseg_cmn = subseg_cmn

    # ---- core ----
    def _fbank_cfg(self):
        return FbankConfig(num_mel_bins=self.feat_dim,
                           window_type=self.window_type, dither=0.0,
                           sample_rate=self.resample_rate)

    def compute_features(self, wavform, sample_rate=16000, cmn=True
                         ) -> torch.Tensor:
        """(T, F) fbank of a [-1, 1] waveform (scaled by 2^15 unless
        set_wavform_norm), resampled to the model's rate, on the
        Speaker's device."""
        wav = np.asarray(wavform, np.float32)
        if not self.wavform_norm:
            wav = wav * (1 << 15)
        wav = resample_array(wav, sample_rate, self.resample_rate)
        feats = compute_fbank(torch.as_tensor(wav, device=self.device),
                              self._fbank_cfg())
        if cmn:
            feats = feats - feats.mean(dim=0)
        return feats

    def extract_embedding_from_pcm(self, pcm: np.ndarray, sample_rate: int):
        wav = np.asarray(pcm, np.float32)
        if wav.ndim > 1:
            wav = wav[0]
        if self.apply_vad:
            segs = energy_vad(wav, sample_rate)
            if segs:
                wav = np.concatenate([
                    wav[int(b * sample_rate):int(e * sample_rate)]
                    for b, e in segs])
        feats = self.compute_features(wav, sample_rate)
        return self._embed_batch(feats[None])[0].cpu().numpy()

    def extract_embedding(self, audio_path: str) -> np.ndarray:
        wav, sr = read_wav(audio_path)
        if wav.ndim > 1:
            wav = wav[0]
        return self.extract_embedding_from_pcm(wav, sr)

    def extract_embedding_list(self, scp_path: str
                               ) -> Tuple[List[str], List[np.ndarray]]:
        names, embeddings = [], []
        with open(scp_path) as f:
            for line in f:
                name, path = line.split()
                names.append(name)
                embeddings.append(self.extract_embedding(path))
        return names, embeddings

    def cosine_similarity(self, e1, e2) -> float:
        s = np.dot(e1, e2) / (np.linalg.norm(e1) * np.linalg.norm(e2))
        return float((s + 1.0) / 2.0)  # [0, 1] like the reference

    def compute_similarity(self, audio_path1: str, audio_path2: str) -> float:
        return self.cosine_similarity(self.extract_embedding(audio_path1),
                                      self.extract_embedding(audio_path2))

    def extract_embedding_from_feats(self, fbanks, batch_size: int = None,
                                     subseg_cmn: bool = None) -> np.ndarray:
        """Batched embeddings from precomputed fbank windows
        (cli/speaker.py:108-123): optional per-window CMN, fixed-size
        batches with the last zero-padded."""
        batch_size = batch_size or self.diar_batch_size
        if subseg_cmn is None:
            subseg_cmn = self.diar_subseg_cmn
        arr = torch.as_tensor(np.stack([np.asarray(f, np.float32)
                                        for f in fbanks]), device=self.device)
        if subseg_cmn:
            arr = arr - arr.mean(dim=1, keepdim=True)
        return embed_windows(arr, self._embed_batch,
                             batch_size).cpu().numpy()

    def register(self, name: str, audio_path: str):
        if name in self.table:
            raise ValueError(f"speaker {name} already registered")
        self.table[name] = self.extract_embedding(audio_path)

    def recognize(self, audio_path: str):
        emb = self.extract_embedding(audio_path)
        best_name, best_score = "", 0.0
        for name, e in self.table.items():
            score = self.cosine_similarity(emb, e)
            if score > best_score:
                best_name, best_score = name, score
        return {"name": best_name, "confidence": best_score}

    def diarize(self, audio_path: str, utt: str = "unk"):
        wav, sr = read_wav(audio_path)
        if wav.ndim > 1:
            wav = wav[0]
        if sr != self.resample_rate:
            wav, sr = resample_array(wav, sr, self.resample_rate), \
                self.resample_rate
        fs = self.diar_frame_shift
        sad = [(b, e) for b, e in energy_vad(wav, sr)
               if e - b >= self.diar_min_duration]
        merged, _ = diarize_wav(
            utt, wav, sr, self._embed_batch, sad_segments=sad,
            fbank_cfg=dataclasses.replace(self._fbank_cfg(),
                                          frame_shift_ms=fs),
            window_fs=int(self.diar_window_secs * 1000 / fs),
            period_fs=int(self.diar_period_secs * 1000 / fs),
            clusterer="umap", num_spks=self.diar_num_spks,
            batch_size=self.diar_batch_size,
            subseg_cmn=self.diar_subseg_cmn, device=self.device)
        return merged

    def diarize_list(self, scp_path: str):
        out = []
        with open(scp_path) as f:
            for line in f:
                utt, path = line.split()
                out.append((utt, self.diarize(path, utt)))
        return out

    def make_rttm(self, merged_segment_to_labels, outfile):
        with open(outfile, "w") as f:
            for (utt, begin, end, label) in merged_segment_to_labels:
                f.write(RTTM_LINE.format(utt, 1, begin, end - begin, label)
                        + "\n")


def load_model_local(model_dir: str, device: DeviceLike = None) -> Speaker:
    return Speaker(model_dir, device)


def load_model(model_name_or_path: str, device: DeviceLike = None
               ) -> Speaker:
    """A local model directory. Hub names ('chinese', 'english', ...) are
    refused: the JAX package's downloading hub (cli/hub.py) is not
    ported."""
    if os.path.isdir(model_name_or_path):
        return Speaker(model_name_or_path, device)
    raise NotImplementedError(
        f"'{model_name_or_path}' is not a model directory; hub models "
        "(wespeaker_tpu/cli/hub.py, which downloads) are not ported: pass "
        "a directory with config.yaml and a checkpoint")


def main(argv=None):
    parser = argparse.ArgumentParser(description="wespeaker-tpu CLI (port)")
    parser.add_argument("-t", "--task", default="embedding",
                        choices=["embedding", "embedding_kaldi", "similarity",
                                 "diarization", "diarization_list"])
    parser.add_argument("-p", "--pretrain", default=None,
                        help="model directory")
    parser.add_argument("-l", "--language", default="chinese",
                        choices=["chinese", "english"],
                        help="hub model when --pretrain is omitted (not "
                             "ported: refused)")
    parser.add_argument("--audio_file", default=None)
    parser.add_argument("--audio_file2", default=None)
    parser.add_argument("--wav_scp", default=None)
    parser.add_argument("--resample_rate", type=int, default=16000)
    parser.add_argument("--vad", action="store_true")
    parser.add_argument("--output_file", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    # diarization knobs (reference cli/utils.py:95-121 defaults)
    parser.add_argument("--diar_num_spks", type=int, default=None)
    parser.add_argument("--diar_min_duration", type=float, default=0.255)
    parser.add_argument("--diar_window_secs", type=float, default=1.5)
    parser.add_argument("--diar_period_secs", type=float, default=0.75)
    parser.add_argument("--diar_frame_shift", type=int, default=10)
    parser.add_argument("--diar_emb_bs", type=int, default=32)
    parser.add_argument("--diar_subseg_cmn", default=True,
                        type=lambda x: str(x).lower() == "true")
    args = parser.parse_args(argv)

    model = load_model(args.pretrain or args.language, args.device)
    model.set_resample_rate(args.resample_rate)
    model.set_vad(args.vad)
    model.set_diarization_params(num_spks=args.diar_num_spks,
                                 min_duration=args.diar_min_duration,
                                 window_secs=args.diar_window_secs,
                                 period_secs=args.diar_period_secs,
                                 frame_shift=args.diar_frame_shift,
                                 batch_size=args.diar_emb_bs,
                                 subseg_cmn=args.diar_subseg_cmn)

    if args.task == "embedding":
        emb = model.extract_embedding(args.audio_file)
        out = args.output_file or "embedding.txt"
        np.savetxt(out, emb)
        print(f"embedding -> {out}")
    elif args.task == "embedding_kaldi":
        from wespeaker_tpu_torch.utils.kaldi_io import write_vec_ark_scp
        names, embs = model.extract_embedding_list(args.wav_scp)
        prefix = args.output_file or "embedding"
        write_vec_ark_scp(prefix, zip(names, embs))
        print(f"embeddings -> {prefix}.ark/.scp")
    elif args.task == "similarity":
        print(model.compute_similarity(args.audio_file, args.audio_file2))
    elif args.task in ("diarization", "diarization_list"):
        if args.task == "diarization":
            merged = model.diarize(args.audio_file)
        else:
            merged = [seg for _, segs in model.diarize_list(args.wav_scp)
                      for seg in segs]
        if args.output_file:
            model.make_rttm(merged, args.output_file)
        else:
            for (utt, b, e, lab) in merged:
                print(f"{utt} {b:.3f} {e:.3f} {lab}")


if __name__ == "__main__":
    main()
