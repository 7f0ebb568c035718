"""Host-side data pipeline stages: a copy of
wespeaker_tpu/data/pipeline.py (upstream wespeaker/dataset/processor.py).

Generator chain: global list shuffle -> parse (tar shard / jsonl raw /
kaldi feat) -> filter (drop short, cap long) -> resample -> local shuffle
-> spk2id -> speed perturb (labels offset by num_spks * speed_idx) ->
random chunk (repeat-pad) -> reverb/noise augmentation -> batch. Pure
numpy; fbank, CMVN and spec-aug run on the device in the train step.
Every random choice draws from the numpy Generator passed in, so the same
seed gives the same samples, crops, SNRs and RIRs as the JAX package, bit
for bit. Speed perturb is polyphase resampling (sox's `speed` + `rate`);
the chunk length ((num_frms - 1) * frame_shift + frame_length) ms yields
exactly num_frms fbank frames. MUSAN noise and RIRs come from packed
stores (data/store.py). With `device_aug` the host only picks the RIR or
noise and the SNR (`attach_device_aug`) and the card convolves and mixes
(train/device_aug.py). A shard list may name http(s) URLs: each streams
through urllib into tarfile's stream mode, as in the JAX package.
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


def _open_shard(path: str):
    """-> (tarfile, the http response to close or None); raises if the
    shard cannot be opened. A URL is read as a stream (mode "r|*")."""
    if not path.startswith(("http://", "https://")):
        return tarfile.open(path), None
    import urllib.request
    stream = urllib.request.urlopen(path)
    try:
        return tarfile.open(fileobj=stream, mode="r|*"), stream
    except Exception:
        stream.close()
        raise


def parse_shard(tar_paths: Iterable[str]) -> Iterator[dict]:
    """Tar shards of <key>.wav + <key>.spk entries grouped by prefix
    (upstream processor.py tar_file_and_group:68); http(s) URLs stream
    through urllib (upstream shells out to wget, processor.py
    url_opener:37); shards that cannot be opened are skipped."""
    for path in tar_paths:
        try:
            tf, stream = _open_shard(path)
        except Exception:
            continue
        try:
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
        finally:
            tf.close()
            if stream is not None:
                stream.close()


def parse_feat(scp_lines: Iterable[str],
               utt2spk: Dict[str, str]) -> Iterator[dict]:
    """Precomputed kaldi features (upstream processor.py parse_feat:171):
    {"key", "spk", "feat" (T, F)} for each scp line whose key has a
    speaker."""
    for key, feat in read_vec_scp_iterlines(scp_lines):
        if key in utt2spk:
            yield {"key": key, "spk": utt2spk[key], "feat": feat}


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


def speed_perturb_expand(data, num_spks: int):
    """Every utterance at each of the speeds 1.0, 0.9 and 1.1, in that
    order, as three samples (the W2V-BERT recipe, upstream
    processor.py:291-313)."""
    speeds = [1.0, 0.9, 1.1]
    for sample in data:
        for idx, speed in enumerate(speeds):
            out = dict(sample)
            if idx > 0:
                out["wav"] = _speed_resample(sample["wav"], speed,
                                             sample["sample_rate"])
            out["label"] = sample["label"] + num_spks * idx
            yield out


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


def filter_and_cap(data, min_num_frames=100, max_num_frames=800,
                   frame_shift=10, rng: Optional[np.random.Generator] = None,
                   feat_mode: bool = False):
    """Drop too-short utterances; random-chunk too-long ones (upstream
    processor.py:350-392). In `feat_mode` the limits count feature rows."""
    rng = rng or np.random.default_rng()
    for sample in data:
        if feat_mode:
            feat = sample["feat"]
            if len(feat) < min_num_frames:
                continue
            if len(feat) > max_num_frames:
                sample["feat"] = get_random_chunk(feat, max_num_frames, rng)
        else:
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
                 rng: Optional[np.random.Generator] = None,
                 feat_mode: bool = False):
    rng = rng or np.random.default_rng()
    key = "feat" if feat_mode else "wav"
    for sample in data:
        sample[key] = get_random_chunk(sample[key], chunk_len, rng)
        yield sample


def _snr_range_for(key: str):
    """The SNR range (dB) of a MUSAN noise by its key's kind."""
    if key.startswith("noise"):
        return (0, 15)
    if key.startswith("speech"):
        return (10, 30)
    if key.startswith("music"):
        return (5, 15)
    return (0, 15)


def augment_one(audio: np.ndarray, reverb_store, noise_store,
                rng: np.random.Generator) -> np.ndarray:
    """One wav through the reverb-or-noise branch and a peak normalise
    (upstream processor.py:439-494): with both stores a coin picks the
    branch. Reverb convolves with an energy-normalised RIR (scipy's
    fftconvolve, cut to the input's length); noise is a random chunk of a
    store entry scaled to an SNR drawn from its kind's range. Shared by
    the per-sample stage and the SSL per-view augmentation."""
    from scipy.signal import fftconvolve

    n = audio.shape[0]
    use_reverb = reverb_store is not None and (
        noise_store is None or rng.integers(1, 3) == 1)
    if use_reverb:
        _, rir = reverb_store.random_one(rng)
        rir = rir / np.sqrt(np.sum(rir ** 2) + 1e-12)
        out = fftconvolve(audio, rir, mode="full")[:n]
    else:
        audio_db = 10 * np.log10(np.mean(audio ** 2) + 1e-4)
        key, noise = noise_store.random_one(rng)
        noise = get_random_chunk(noise, n, rng)
        lo, hi = _snr_range_for(key)
        snr = rng.uniform(lo, hi)
        noise_db = 10 * np.log10(np.mean(noise ** 2) + 1e-4)
        noise = np.sqrt(10 ** ((audio_db - noise_db - snr) / 10)) * noise
        out = audio + noise
    return (out / (np.max(np.abs(out)) + 1e-4)).astype(np.float32)


def make_crop_aug(reverb_store, noise_store, aug_prob: float):
    """Per-view aug_fn(wav, rng) for ssl/dataset.multi_crop: each view is
    augmented on its own with probability aug_prob (upstream
    ssl/dataset/processor.py:166-216). None without a store or with
    aug_prob <= 0, so the views go unaugmented."""
    if not (reverb_store or noise_store) or aug_prob <= 0:
        return None

    def aug(wav, rng):
        if rng.uniform() < aug_prob:
            return augment_one(wav, reverb_store, noise_store, rng)
        return wav

    return aug


def add_reverb_noise(data, reverb_store=None, noise_store=None,
                     aug_prob: float = 0.6,
                     rng: Optional[np.random.Generator] = None):
    """Each sample through augment_one with probability aug_prob (upstream
    processor.py:421-494)."""
    rng = rng or np.random.default_rng()
    for sample in data:
        if rng.uniform() < aug_prob and (reverb_store or noise_store):
            sample["wav"] = augment_one(sample["wav"], reverb_store,
                                        noise_store, rng)
        yield sample


def attach_device_aug(data, reverb_store=None, noise_store=None,
                      aug_prob: float = 0.6, rir_samples: int = 16000,
                      rng: Optional[np.random.Generator] = None):
    """The host half of device-side augmentation: the same draws as
    add_reverb_noise pick the branch, the RIR or noise and the SNR, and
    the sample carries them as `aug_mode` (0 none, 1 reverb, 2 noise),
    `aug_rir` (rir_samples int16, the RIR cut or zero-padded), `aug_noise`
    (the wav's length, int16) and `aug_snr` (dB). The store's int16 goes
    out unconverted; the card converts, convolves, mixes and normalises
    (train/device_aug.py::device_augment)."""
    rng = rng or np.random.default_rng()
    for sample in data:
        n = sample["wav"].shape[0]
        mode, snr = 0, 0.0
        rir = np.zeros(rir_samples, np.int16)
        noise = np.zeros(n, np.int16)
        if rng.uniform() < aug_prob and (reverb_store or noise_store):
            use_reverb = reverb_store is not None and (
                noise_store is None or rng.integers(1, 3) == 1)
            if use_reverb:
                mode = 1
                _, r = reverb_store.random_one_raw(rng)
                r = r[:rir_samples]
                rir[:r.shape[0]] = r
            else:
                mode = 2
                key, nz = noise_store.random_one_raw(rng)
                noise = get_random_chunk(nz, n, rng)
                lo, hi = _snr_range_for(key)
                snr = float(rng.uniform(lo, hi))
        sample["aug_mode"] = mode
        sample["aug_rir"] = rir
        sample["aug_noise"] = noise
        sample["aug_snr"] = snr
        yield sample


def batch_samples(data, batch_size: int,
                  feat_mode: bool = False) -> Iterator[dict]:
    """Stack fixed-shape samples into {'wav' (B, N) or 'feat' (B, T, F)
    f32, 'label' (B,) i32, 'key' [B]}. Samples from attach_device_aug
    also give 'aug_mode' (B,) i32, 'aug_rir' (cap, R), 'aug_noise' (B, N)
    and 'aug_snr' (B,) f32, with cap = max(B // 2, 1): the reverb samples
    are packed first, since the card convolves only the first cap rows,
    and a reverb sample beyond them goes unaugmented (mode 0)."""
    key = "feat" if feat_mode else "wav"
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) == batch_size:
            if "aug_mode" in buf[0]:
                buf.sort(key=lambda s: s["aug_mode"] != 1)  # stable
                cap = max(batch_size // 2, 1)
                for s in buf[cap:]:
                    if s["aug_mode"] == 1:
                        s["aug_mode"] = 0
            batch = {
                key: np.stack([s[key] for s in buf]).astype(np.float32),
                "label": np.asarray([s["label"] for s in buf], np.int32),
                "key": [s["key"] for s in buf],
            }
            if "aug_mode" in buf[0]:
                batch["aug_mode"] = np.asarray(
                    [s["aug_mode"] for s in buf], np.int32)
                batch["aug_rir"] = np.stack(
                    [s["aug_rir"] for s in buf[:cap]])
                batch["aug_noise"] = np.stack([s["aug_noise"] for s in buf])
                batch["aug_snr"] = np.asarray(
                    [s["aug_snr"] for s in buf], np.float32)
            yield batch
            buf = []
