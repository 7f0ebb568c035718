"""Host-side data pipeline stages: a copy of the parts of
wespeaker_tpu/data/pipeline.py that the raw and shard training paths and
serving use (upstream wespeaker/dataset/processor.py).

Generator chain: global list shuffle -> parse (tar shard / jsonl raw) ->
filter (drop short, cap long) -> resample -> local shuffle -> spk2id ->
speed perturb (labels offset by num_spks * speed_idx) -> random chunk
(repeat-pad) -> batch. Pure numpy; fbank, CMVN and spec-aug run on the
device in the train step. Every random choice draws from the numpy
Generator passed in, so the same seed gives the same samples as the JAX
package. Speed perturb is polyphase resampling (sox's `speed` + `rate`);
the chunk length ((num_frms - 1) * frame_shift + frame_length) ms yields
exactly num_frms fbank frames. Kaldi scp lines are read for extraction
(`read_vec_scp_iterlines`). Not ported yet: the kaldi feature input of
training, reverb/noise augmentation (`make_crop_aug` refuses a store),
the expanded speed perturb and http(s) shards.
"""

import json
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from wespeaker_tpu_torch.data.wav_io import read_wav
from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp_lines

AUDIO_EXTS = (".wav", ".flac")


def read_lists(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def spk2id_from_utt2spk(utt2spk_path: str) -> Dict[str, int]:
    """Sorted speaker -> id map (upstream wespeaker/utils/utils.py)."""
    spks = set()
    with open(utt2spk_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                spks.add(parts[1])
    return {s: i for i, s in enumerate(sorted(spks))}


def distributed_shard(lists: List[str], *, epoch: int = 0, shuffle: bool = True,
                      seed: int = 42, rank: int = 0, world_size: int = 1,
                      worker_id: int = 0, num_workers: int = 1) -> List[str]:
    """Global per-epoch shuffle then rank/worker striding
    (upstream dataset.py:54-100)."""
    data = list(lists)
    if shuffle:
        rng = np.random.default_rng(seed + epoch)
        rng.shuffle(data)
    data = data[rank::world_size]
    return data[worker_id::num_workers]


def read_audio_any(src: str):
    """Path, or kaldi-style pipe command ('sox ... |') whose stdout is a
    RIFF wav (upstream processor.py:129-136)."""
    if src.endswith("|"):
        import subprocess
        data = subprocess.run(src[:-1], shell=True, check=True,
                              stdout=subprocess.PIPE).stdout
        return read_wav(data)
    return read_wav(src)


def parse_raw(lines: Iterable[str]) -> Iterator[dict]:
    """jsonl: {"key","wav","spk"(, "vad":[[s,e],...] seconds)}; unreadable
    audio is skipped."""
    for line in lines:
        obj = json.loads(line)
        try:
            wav, sr = read_audio_any(obj["wav"])
        except Exception:
            continue
        if wav.ndim > 1:
            wav = wav[0]
        if "vad" in obj and obj["vad"]:
            segs = [wav[int(s * sr):int(e * sr)] for s, e in obj["vad"]]
            wav = np.concatenate(segs) if segs else wav
        yield {"key": obj["key"], "spk": obj["spk"], "wav": wav,
               "sample_rate": sr}


def parse_shard(tar_paths: Iterable[str]) -> Iterator[dict]:
    """Tar shards of <key>.wav + <key>.spk entries grouped by prefix
    (upstream processor.py tar_file_and_group:68); unreadable shards are
    skipped."""
    for path in tar_paths:
        if path.startswith(("http://", "https://")):
            raise ValueError(f"shard {path}: http(s) shards are not ported "
                             "yet; give a local path")
        try:
            tf = tarfile.open(path)
        except Exception:
            continue
        with tf:
            current = {}
            prev_key = None
            for member in tf:
                name = member.name
                dot = name.rfind(".")
                key, ext = name[:dot], name[dot:]
                if prev_key is not None and key != prev_key:
                    if "wav" in current and "spk" in current:
                        yield current
                    current = {}
                prev_key = key
                data = tf.extractfile(member).read()
                if ext in AUDIO_EXTS:
                    wav, sr = read_wav(data)
                    if wav.ndim > 1:
                        wav = wav[0]
                    current.update(key=key, wav=wav, sample_rate=sr)
                elif ext == ".spk":
                    current["spk"] = data.decode().strip()
            if "wav" in current and "spk" in current:
                yield current


# (key, array) from kaldi scp lines; the parser lives in utils.kaldi_io
read_vec_scp_iterlines = read_vec_scp_lines


def local_shuffle(data: Iterator[dict], buffer_size: int = 2500,
                  rng: Optional[np.random.Generator] = None) -> Iterator[dict]:
    rng = rng or np.random.default_rng()
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= buffer_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def spk_to_id(data, spk2id: Dict[str, int]):
    for sample in data:
        sample["label"] = spk2id.get(sample["spk"], -1)
        if sample["label"] >= 0:
            yield sample


def resample_array(wav: np.ndarray, sr: int,
                   target_rate: int = 16000) -> np.ndarray:
    """Polyphase resampling from `sr` to `target_rate`."""
    from scipy.signal import resample_poly

    if sr == target_rate:
        return wav
    g = int(np.gcd(sr, target_rate))
    return resample_poly(wav, target_rate // g, sr // g).astype(np.float32)


def resample(data, target_rate: int = 16000):
    for sample in data:
        sr = sample.get("sample_rate", target_rate)
        if sr != target_rate:
            sample["wav"] = resample_array(sample["wav"], sr, target_rate)
            sample["sample_rate"] = target_rate
        yield sample


def _speed_resample(wav: np.ndarray, speed: float, sr: int) -> np.ndarray:
    """sox 'speed f' + 'rate sr': time-scale by 1/f via polyphase."""
    from scipy.signal import resample_poly

    frac = {0.9: (10, 9), 1.1: (10, 11)}.get(speed)
    if frac is None:
        num = round(speed * 100)
        g = int(np.gcd(100, num))
        frac = (100 // g, num // g)
    return resample_poly(wav, frac[0], frac[1]).astype(np.float32)


def speed_perturb(data, num_spks: int,
                  rng: Optional[np.random.Generator] = None):
    """Random {1.0, 0.9, 1.1} speed; perturbed speeds become new classes:
    label += num_spks * speed_idx (upstream processor.py:263-289)."""
    rng = rng or np.random.default_rng()
    speeds = [1.0, 0.9, 1.1]
    for sample in data:
        idx = int(rng.integers(0, 3))
        if idx > 0:
            sample["wav"] = _speed_resample(sample["wav"], speeds[idx],
                                            sample["sample_rate"])
            sample["label"] = sample["label"] + num_spks * idx
        yield sample


def get_random_chunk(data: np.ndarray, chunk_len: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Random crop, or tile-repeat then cut when too short
    (upstream processor.py:315-348)."""
    n = data.shape[0]
    if n >= chunk_len:
        start = int(rng.integers(0, n - chunk_len + 1))
        return np.array(data[start:start + chunk_len])
    reps = chunk_len // n + 1
    tiled = np.tile(data, (reps,) + (1,) * (data.ndim - 1))
    return tiled[:chunk_len]


def make_crop_aug(reverb_store, noise_store, aug_prob: float):
    """Per-view aug_fn for ssl/dataset.multi_crop: None without a reverb or
    noise store (or with aug_prob <= 0), so the views go unaugmented, as in
    the JAX package. The stores are not ported, and one given raises."""
    if not (reverb_store or noise_store) or aug_prob <= 0:
        return None
    raise NotImplementedError("reverb/noise augmentation is not ported yet")


def filter_and_cap(data, min_num_frames=100, max_num_frames=800,
                   frame_shift=10, rng: Optional[np.random.Generator] = None):
    """Drop too-short utterances; random-chunk too-long ones
    (upstream processor.py:350-392)."""
    rng = rng or np.random.default_rng()
    for sample in data:
        sr = sample["sample_rate"]
        wav = sample["wav"]
        min_len = int(frame_shift / 1000 * min_num_frames * sr)
        max_len = int(frame_shift / 1000 * max_num_frames * sr)
        if len(wav) < min_len:
            continue
        if len(wav) > max_len:
            sample["wav"] = get_random_chunk(wav, max_len, rng)
        yield sample


def random_chunk(data, chunk_len: int,
                 rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    for sample in data:
        sample["wav"] = get_random_chunk(sample["wav"], chunk_len, rng)
        yield sample


def batch_samples(data, batch_size: int) -> Iterator[dict]:
    """Stack fixed-shape samples into {'wav' (B, N) f32, 'label' (B,) i32,
    'key' [B]}."""
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) == batch_size:
            yield {"wav": np.stack([s["wav"] for s in buf]).astype(
                       np.float32),
                   "label": np.asarray([s["label"] for s in buf], np.int32),
                   "key": [s["key"] for s in buf]}
            buf = []
