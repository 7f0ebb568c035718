"""Embedding-serving daemon for the card: HTTP + dynamic batching.

Counterpart of wespeaker_tpu/serving.py, with the same batcher and
endpoints. One process owns the card; a collator thread gathers concurrent
requests into padded batches (batch rounded to a power of two, length to a
sample quantum, a frame mask for the padding), so the padded bucket gives
each utterance the embedding of its batch=1 forward.

Endpoints:
  GET  /health              -> {"status": "ok"}
  POST /embed               -> {"embedding": [...]} ; body is a RIFF wav
                               (Content-Type audio/wav) or JSON
                               {"wav": [...float], "sample_rate": 16000}
  POST /diarize             -> {"segments": [{"begin", "end", "speaker"}]}
                               ; body as /embed: energy VAD, sliding-window
                               embeddings, spectral clustering
                               (diar/pipeline.py::diarize_wav)
  POST /similarity          -> {"similarity": s} ; JSON {"wav1": .., "wav2"}
                               cosine mapped to [0, 1]
"""

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from wespeaker_tpu_torch.device import DeviceLike, resolve_device


class DynamicBatcher:
    """Collate concurrent embed requests into padded batches.

    embed_fn(wavs (B, L) f32, mask (B, L) f32) -> (B, D) f32 must accept
    any (power-of-two B, quantum-multiple L) shape."""

    def __init__(self, embed_fn, max_batch: int = 16, max_wait_ms: float = 5,
                 quantum_samples: int = 16000,
                 max_samples: int = 16000 * 120, min_samples: int = 400,
                 reply_timeout_s: float = 300.0):
        self.embed_fn = embed_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.quantum = quantum_samples
        self.max_samples = max_samples
        # shorter than one fbank window would mask out every frame
        self.min_samples = min_samples
        self.reply_timeout_s = reply_timeout_s
        self.q: "queue.Queue" = queue.Queue()
        self._stop = False
        # orders enqueues against close(): an item put under the lock is
        # always ahead of the stop sentinel, so the worker drains it
        self._stop_lock = threading.Lock()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def embed(self, wav: np.ndarray) -> np.ndarray:
        """Blocking: enqueue one utterance, wait for its embedding."""
        wav = np.asarray(wav, np.float32)
        if wav.size < self.min_samples:
            raise ValueError(
                f"waveform too short: {wav.size} < {self.min_samples} "
                "samples (one analysis window)")
        done = threading.Event()
        slot = {}
        with self._stop_lock:
            if self._stop:
                raise RuntimeError("batcher closed")
            self.q.put((wav, slot, done))
        if not done.wait(timeout=self.reply_timeout_s) and not slot:
            raise RuntimeError("embed timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["embedding"]

    def close(self):
        with self._stop_lock:
            self._stop = True
            self.q.put(None)
        self.thread.join(timeout=5)
        # fail any requests still queued so their handler threads unblock
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            _, slot, done = item
            slot["error"] = "batcher closed"
            done.set()

    def _drain_group(self, first):
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self.q.put(item)  # re-emit so the worker loop sees stop
                break
            group.append(item)
        return group

    def _worker(self):
        while not self._stop:
            item = self.q.get()
            if item is None:
                if self._stop:
                    return
                continue
            group = self._drain_group(item)
            try:
                self._run(group)
            except Exception as e:  # report to every waiter, keep serving
                for _, slot, done in group:
                    slot["error"] = repr(e)
                    done.set()

    def _run(self, group):
        b = 1
        while b < len(group):
            b *= 2
        longest = min(max(len(w) for w, _, _ in group), self.max_samples)
        padded_len = max(1, -(-longest // self.quantum)) * self.quantum
        wavs = np.zeros((b, padded_len), np.float32)
        mask = np.zeros((b, padded_len), np.float32)
        for i, (w, _, _) in enumerate(group):
            w = w[:padded_len]
            wavs[i, :len(w)] = w
            mask[i, :len(w)] = 1.0
        mask[len(group):, :self.quantum] = 1.0  # keep pad rows finite
        out = np.asarray(self.embed_fn(wavs, mask))
        for i, (_, slot, done) in enumerate(group):
            slot["embedding"] = out[i]
            done.set()


def build_embed_fn(configs: dict, checkpoint_path: str,
                   device: DeviceLike = None):
    """config + checkpoint -> (embed, diarize) from one model, as the JAX
    package's build_embed_fn returns them. embed: (wavs, mask) -> (B, D)
    numpy embeddings; diarize: (wav, sr) -> merged segments [(utt, begin,
    end, label)] (diar/pipeline.py::diarize_wav: energy VAD, spectral
    clustering with the count estimated; None under a non-fbank frontend,
    as in the JAX package; /diarize then answers 501). The
    checkpoint is a
    torch state_dict (`.pt`, loaded with weights_only=True) or a JAX
    `.ckpt` (bin/extract.py's load_model_for_eval); both run in f32."""
    from wespeaker_tpu_torch.bin.extract import (fbank_config,
                                                 load_model_for_eval)
    from wespeaker_tpu_torch.diar.pipeline import diarize_wav, model_embedder
    from wespeaker_tpu_torch.train.composite import featurizers
    from wespeaker_tpu_torch.train.train_step import make_eval_embed_fn

    dev = resolve_device(device)
    model = load_model_for_eval(configs, checkpoint_path, dev)
    fbank_cfg = fbank_config(configs)
    featurize_eval = featurizers(configs)[1]
    fn = make_eval_embed_fn(model, fbank_cfg, device=dev,
                            featurize_fn=featurize_eval)

    def embed(wavs, mask):
        return fn({"wav": wavs, "mask": mask}).cpu().numpy()

    if featurize_eval is not None:
        return embed, None  # diarization windows are fbank, as in JAX
    embed_windows = model_embedder(model)

    def diarize(wav, sr):
        return diarize_wav("utt", wav, sr, embed_windows,
                           fbank_cfg=fbank_cfg, device=dev)[0]

    return embed, diarize


def _decode_wav_body(body: bytes, content_type: str, default_sr: int):
    from wespeaker_tpu_torch.data.wav_io import read_wav
    if content_type.startswith("audio/"):
        wav, sr = read_wav(bytes(body))
        if wav.ndim > 1:
            wav = wav[0]
        return wav, sr
    obj = json.loads(body)
    return (np.asarray(obj["wav"], np.float32),
            int(obj.get("sample_rate", default_sr)))


def make_server(batcher: DynamicBatcher, host: str = "127.0.0.1",
                port: int = 8086, resample_rate: int = 16000,
                diarize_fn: Optional[Callable] = None):
    def to_model_rate(wav, sr):
        wav = np.asarray(wav, np.float32)
        if sr == resample_rate:
            return wav
        from wespeaker_tpu_torch.data.pipeline import resample_array
        return resample_array(wav, sr, resample_rate)

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every reply sends Content-Length
        protocol_version = "HTTP/1.1"
        # on a persistent connection Nagle would hold the body behind the
        # header block until the client's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code, obj):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "application/json")
                if self.path == "/embed":
                    wav, sr = _decode_wav_body(body, ctype, resample_rate)
                    emb = batcher.embed(to_model_rate(wav, sr))
                    self._reply(200, {"embedding": emb.tolist()})
                elif self.path == "/diarize":
                    if diarize_fn is None:
                        self._reply(501, {"error": "no diarization function "
                                          "was given to this server"})
                        return
                    wav, sr = _decode_wav_body(body, ctype, resample_rate)
                    merged = diarize_fn(to_model_rate(wav, sr),
                                        resample_rate)
                    self._reply(200, {"segments": [
                        {"begin": round(float(b), 3),
                         "end": round(float(e), 3),
                         "speaker": int(lab)}
                        for (_, b, e, lab) in merged]})
                elif self.path == "/similarity":
                    obj = json.loads(body)
                    sr = int(obj.get("sample_rate", resample_rate))
                    e1 = batcher.embed(to_model_rate(obj["wav1"], sr))
                    e2 = batcher.embed(to_model_rate(obj["wav2"], sr))
                    cos = float(np.dot(e1, e2)
                                / (np.linalg.norm(e1) * np.linalg.norm(e2)
                                   + 1e-12))
                    self._reply(200, {"similarity": (cos + 1.0) / 2.0})
                else:
                    self._reply(404, {"error": "not found"})
            except BrokenPipeError:
                pass
            except Exception as e:  # a bad request must not kill the server
                self._reply(400, {"error": repr(e)})

    class Server(ThreadingHTTPServer):
        # the default listen backlog of 5 drops SYNs under a connect burst
        request_queue_size = 128

    return Server((host, port), Handler)


class EmbeddingServer:
    """Owns batcher + HTTP server; start()/close() for tests and scripts,
    httpd.serve_forever() for the CLI. Runs on the card unless the caller
    passes device="cpu"; raises when no card is present otherwise."""

    def __init__(self, configs: dict, checkpoint_path: str,
                 host: str = "127.0.0.1", port: int = 8086,
                 max_batch: int = 16, max_wait_ms: float = 5,
                 embed_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        diarize_fn = None  # a caller's embed_fn comes without one
        if embed_fn is None:
            embed_fn, diarize_fn = build_embed_fn(configs, checkpoint_path,
                                                  self.device)
        rate = configs.get("dataset_args", {}).get("resample_rate", 16000)
        self.batcher = DynamicBatcher(
            embed_fn, max_batch=max_batch, max_wait_ms=max_wait_ms,
            quantum_samples=rate, max_samples=rate * 120,
            min_samples=int(rate * 0.025))
        self.httpd = make_server(self.batcher, host, port,
                                 resample_rate=rate, diarize_fn=diarize_fn)
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
