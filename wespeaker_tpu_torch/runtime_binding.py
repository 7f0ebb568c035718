"""ctypes bridge to the C++ deployment runtime (runtime/core).

Counterpart of wespeaker_tpu/runtime_binding.py. The runtime owns the wav
IO, the fbank, the chunking and the per-chunk CMN (runtime/core/capi.cc,
speaker/speaker_engine.h); the embedding model is either its built-in
mean-mel smoke model or a Python callback, here a port model run on its
device (`model_embed_fn`: on the card, ECAPA's eval kernels).

The library and the two binaries (core/bin/extract_emb_main.cc,
core/bin/asv_main.cc) are built at first use with the host C++ compiler
alone (`$CXX`, else g++ or c++; `-std=c++17 -O2 -fPIC`, include
runtime/core, `-pthread`), no cmake, three compiler processes at once,
into `build/runtime-<hash>/` under the repo root. The hash covers the
sources, the headers and the flags, as ops/_build.py keys the kernels'
libraries. runtime/ itself is not touched.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
RUNTIME_CORE = REPO_ROOT / "runtime" / "core"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")
LIB_NAME = "libwespeaker_tpu_runtime.so"
BINARIES = ("extract_emb_main", "asv_main")

_EMBED_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_float), ctypes.c_void_p)


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand:
            return cand
    raise RuntimeError("no C++ compiler (set CXX) to build runtime/core")


def build_dir() -> Path:
    """build/runtime-<hash of the sources and flags>/."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sorted(RUNTIME_CORE.rglob("*")):
        if src.suffix in (".cc", ".h"):
            h.update(str(src.relative_to(RUNTIME_CORE)).encode())
            h.update(src.read_bytes())
    return REPO_ROOT / "build" / f"runtime-{h.hexdigest()[:12]}"


def build_runtime() -> Path:
    """Compile the library and the binaries not built yet; returns the
    build directory. Raises with the compiler's output on a failure."""
    out_dir = build_dir()
    jobs = [(LIB_NAME, ["-shared", str(RUNTIME_CORE / "capi.cc")])]
    jobs += [(b, [str(RUNTIME_CORE / "bin" / f"{b}.cc")]) for b in BINARIES]
    todo = [(name, args) for name, args in jobs
            if not (out_dir / name).exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, args in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        cmd = [_compiler(), *CXX_FLAGS, f"-I{RUNTIME_CORE}", *args, "-o",
               str(tmp)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / name)  # a loader never sees half
    if failed:
        raise RuntimeError("runtime build failed: " + "\n".join(failed))
    return out_dir


def binary(name: str) -> str:
    """The path of a built runtime binary (extract_emb_main, asv_main)."""
    if name not in BINARIES:
        raise KeyError(name)
    return str(build_runtime() / name)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_runtime() / LIB_NAME))
    p, i, fp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    lib.wtpu_fbank_new.restype = p
    lib.wtpu_fbank_new.argtypes = [i, i, i, i, ctypes.c_char_p,
                                   ctypes.c_float]
    lib.wtpu_fbank_free.argtypes = [p]
    lib.wtpu_fbank_num_frames.argtypes = [p, i]
    lib.wtpu_fbank_num_frames.restype = i
    lib.wtpu_fbank_compute.argtypes = [p, fp, i, fp]
    lib.wtpu_fbank_compute.restype = i
    lib.wtpu_engine_new_meanmel.restype = p
    lib.wtpu_engine_new_meanmel.argtypes = [i, i, i]
    lib.wtpu_engine_new_with_callback.restype = p
    lib.wtpu_engine_new_with_callback.argtypes = [_EMBED_CB, p, i, i, i, i]
    lib.wtpu_engine_free.argtypes = [p]
    lib.wtpu_engine_extract.argtypes = [p, fp, i, fp]
    lib.wtpu_engine_cosine.restype = ctypes.c_float
    lib.wtpu_engine_cosine.argtypes = [p, fp, fp, i]
    lib.wtpu_pipeline_new.restype = p
    lib.wtpu_pipeline_new.argtypes = [i, i]
    lib.wtpu_pipeline_free.argtypes = [p]
    lib.wtpu_pipeline_accept.argtypes = [p, fp, i]
    lib.wtpu_pipeline_finish.argtypes = [p]
    lib.wtpu_pipeline_read.argtypes = [p, i, fp, i]
    lib.wtpu_pipeline_read.restype = i
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeFbank:
    """The runtime's Kaldi fbank: wave in the int16 range -> (T, bins)."""

    def __init__(self, num_bins=80, sample_rate=16000, frame_length_ms=25,
                 frame_shift_ms=10, window_type="hamming", dither=0.0):
        self.lib = load_library()
        self.num_bins = num_bins
        self.handle = self.lib.wtpu_fbank_new(
            num_bins, sample_rate, frame_length_ms, frame_shift_ms,
            window_type.encode(), dither)

    def __call__(self, wave_int16_range: np.ndarray) -> np.ndarray:
        wave = np.ascontiguousarray(wave_int16_range, np.float32)
        n = self.lib.wtpu_fbank_num_frames(self.handle, len(wave))
        out = np.zeros((n, self.num_bins), np.float32)
        got = self.lib.wtpu_fbank_compute(self.handle, _fptr(wave),
                                          len(wave), _fptr(out))
        if got != n:
            raise RuntimeError(f"fbank wrote {got} frames, want {n}")
        return out

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.wtpu_fbank_free(self.handle)


def model_embed_fn(model: torch.nn.Module, device=None
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """A NativeEngine callback: one chunk's (T, F) CMN'd features -> the
    model's (D,) embedding, the forward on `device` (the card unless the
    caller passes device="cpu") in f32 under no_grad. The model should
    already lie on that device, in eval."""
    from wespeaker_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    def embed(feats: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(feats, device=dev)[None]
            return model(x)[0].float().cpu().numpy()

    return embed


def engine_chunks(feats: np.ndarray, chunk_frames: int = 198
                  ) -> List[np.ndarray]:
    """The engine's chunking of (T, F) features, in Python
    (speaker/speaker_engine.h::ExtractEmbedding): whole chunks, then the
    rest after `chunk_frames - rest` frames taken from the utterance's
    head; each chunk then has its own mean over time removed."""
    n = len(feats)
    full, rest = divmod(n, chunk_frames)
    chunks = [feats[c * chunk_frames:(c + 1) * chunk_frames]
              for c in range(full)]
    if rest:
        head = feats[np.arange(chunk_frames - rest) % n]
        chunks.append(np.concatenate([head, feats[full * chunk_frames:]]))
    return [c - c.mean(axis=0, keepdims=True) for c in chunks]


class NativeEngine:
    """The runtime's speaker engine: the built-in mean-mel model, or
    `embed_fn` (e.g. `model_embed_fn(port_model)`) called once a chunk."""

    def __init__(self, feat_dim=80, sample_rate=16000, chunk_frames=198,
                 embed_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 embed_dim: Optional[int] = None):
        self.lib = load_library()
        if embed_fn is None:
            self.embed_dim = feat_dim
            self._cb = None
            self.handle = self.lib.wtpu_engine_new_meanmel(
                feat_dim, sample_rate, chunk_frames)
            return
        if embed_dim is None:
            raise ValueError("embed_fn needs embed_dim")
        self.embed_dim = embed_dim
        self.errors: List[BaseException] = []

        def bridge(feats_ptr, num_frames, fd, out_ptr, _user):
            # an exception must not cross into C++: keep it, write zeros
            try:
                feats = np.ctypeslib.as_array(
                    feats_ptr, shape=(num_frames, fd)).copy()
                emb = np.ascontiguousarray(embed_fn(feats), np.float32)
                if emb.size != embed_dim:
                    raise ValueError(f"embed_fn gave {emb.size} values, "
                                     f"want {embed_dim}")
            except Exception as e:  # re-raised by extract()
                self.errors.append(e)
                emb = np.zeros(embed_dim, np.float32)
            ctypes.memmove(out_ptr, emb.ctypes.data, emb.nbytes)

        self._cb = _EMBED_CB(bridge)  # kept alive as long as the engine
        self.handle = self.lib.wtpu_engine_new_with_callback(
            self._cb, None, embed_dim, feat_dim, sample_rate, chunk_frames)

    def extract(self, wave_int16_range: np.ndarray) -> np.ndarray:
        wave = np.ascontiguousarray(wave_int16_range, np.float32)
        out = np.zeros(self.embed_dim, np.float32)
        self.lib.wtpu_engine_extract(self.handle, _fptr(wave), len(wave),
                                     _fptr(out))
        if self._cb is not None and self.errors:
            err, self.errors = self.errors[0], []
            raise err
        return out

    def cosine(self, a: np.ndarray, b: np.ndarray) -> float:
        a = np.ascontiguousarray(a, np.float32)
        b = np.ascontiguousarray(b, np.float32)
        return float(self.lib.wtpu_engine_cosine(self.handle, _fptr(a),
                                                 _fptr(b), len(a)))

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.wtpu_engine_free(self.handle)


class NativePipeline:
    """The runtime's streaming feature pipeline (AcceptWaveform / Read)."""

    def __init__(self, num_bins=80, sample_rate=16000):
        self.lib = load_library()
        self.num_bins = num_bins
        self.handle = self.lib.wtpu_pipeline_new(num_bins, sample_rate)

    def accept(self, wav_int16_range: np.ndarray):
        wav = np.ascontiguousarray(wav_int16_range, np.float32)
        self.lib.wtpu_pipeline_accept(self.handle, _fptr(wav), len(wav))

    def finish(self):
        self.lib.wtpu_pipeline_finish(self.handle)

    def read(self, n: int) -> np.ndarray:
        out = np.zeros((n, self.num_bins), np.float32)
        got = self.lib.wtpu_pipeline_read(self.handle, n, _fptr(out),
                                          self.num_bins)
        return out[:got]

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.wtpu_pipeline_free(self.handle)
