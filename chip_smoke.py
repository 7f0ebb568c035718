#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wespeaker_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device   the card's name and power limit (nvidia-smi) and the time to
              build the CUDA kernels from csrc/ into build/;
  2. kernels  each kernel against its plain PyTorch version on the card at
              the flagship width (C=512): bf16 unmasked at T=200 (cosine
              >= 0.9999) and f32 masked at T=198 (TF32 off, rtol/atol
              1e-4);
  3. slice    ECAPA_TDNN_GLOB_c512 at full width with random weights and
              randomised BN statistics from a seed: make_eval_embed_fn in
              bf16 over 2 s chunks (32,240 samples), the kernel path
              against the layer-by-layer plain path (cosine >= 0.9999);
              the SE kernel must launch 3 times and the tail kernel once;
  4. serving  an EmbeddingServer on port 0 answers concurrent /embed
              requests of 1 to 3 s and one /similarity; each reply against
              the port's own batch=1 forward (cosine >= 0.9999); both
              kernels must have launched;
  5. timing   CUDA events after warm-up at B=512, T=200, C=512, bf16: each
              kernel and its plain version, with the bound from the shapes
              (989 TFLOP/s bf16, 3.35 TB/s); extraction audio-s/s at B=512.
Then one JSON line of per-kernel results and, last, the result line. Any
failure raises and exits non-zero; without a GPU the script exits 1.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wespeaker_tpu_torch.frontend.fbank import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import (  # noqa: E402
    ECAPA_TDNN_GLOB_c512)
from wespeaker_tpu_torch.ops import _build, mfa_astp, se_block  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
B, T, C = 512, 200, 512
SLICE_BATCH = 64
CHUNK_SAMPLES = (200 - 1) * 160 + 400  # 32,240 samples: 200 frames
CHUNK_SECONDS = 2.0                     # counted as bench.py counts them
SEED = 0


def cosine(a, b):
    """In float64: over millions of elements an f32 sum of squares is off
    by more than the 1e-4 being tested."""
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def row_cosines(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def random_model(dev):
    """ECAPA_TDNN_GLOB_c512 with torch's default init from SEED and BN
    statistics and affines randomised from a generator."""
    torch.manual_seed(SEED)
    model = ECAPA_TDNN_GLOB_c512(80, 192)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.to(dev).eval()


def ragged_mask(rng, b, t, dev):
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    return torch.as_tensor((np.arange(t)[None] < lens[:, None]).astype(
        np.float32), device=dev)


def se_inputs(model, rng, b, t, dtype, dev):
    pre, res2, post, se = model.layer3.se_res2block
    x = torch.as_tensor(rng.standard_normal((b, t, C)).astype(np.float32),
                        device=dev).to(dtype)
    weights = (*pre.folded(), *res2.folded(), *post.folded(), *se.folded())
    return x, [w.detach() for w in weights], model.layer3.dilation


def tail_inputs(model, rng, b, t, dtype, dev):
    xs = [torch.as_tensor(rng.standard_normal((b, t, C)).astype(np.float32),
                          device=dev).to(dtype) for _ in range(3)]
    p = model.pool
    weights = (model.conv.weight[:, :, 0].t(), model.conv.bias,
               p.linear1.weight[:, :, 0].t(), p.linear1.bias,
               p.linear2.weight[:, :, 0].t(), p.linear2.bias)
    return xs, [w.detach() for w in weights]


def compare(got, want, dtype):
    """max abs error and cosine; raises outside the stated tolerance."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    cos = cosine(got, want)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    elif cos < 0.9999:
        raise AssertionError(f"cosine {cos} < 0.9999")
    return err, cos


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for name in _build.KERNELS:
        _build.load(name)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__} cuda "
          f"{torch.version.cuda}; built {sorted(logs) or 'nothing new'} in "
          f"{build_s:.1f} s")
    return smi


def phase_kernels(model, dev):
    rng = np.random.default_rng(SEED)
    errs, parts = {}, []
    for dtype, t, masked in ((torch.bfloat16, T, False),
                             (torch.float32, 198, True)):
        mask = ragged_mask(rng, SLICE_BATCH, t, dev) if masked else None
        x, w, dil = se_inputs(model, rng, SLICE_BATCH, t, dtype, dev)
        got = se_block.fused_se_res2_block(x, *w, dilation=dil, mask=mask)
        torch.cuda.synchronize()
        want = se_block.se_res2_block_reference(x, *w, dilation=dil,
                                                mask=mask)
        err, cos = compare(got, want, dtype)
        errs.setdefault("se", err)
        parts.append(f"se_res2_block {str(dtype)[6:]} T={t} "
                     f"{'masked' if masked else 'unmasked'} "
                     f"max_abs_err={err:.3g} cos={cos:.7f}")
        xs, tw = tail_inputs(model, rng, SLICE_BATCH, t, dtype, dev)
        got = mfa_astp.fused_mfa_astp(*xs, *tw, mask=mask, glob=True)
        torch.cuda.synchronize()
        want = mfa_astp.mfa_astp_reference(*xs, *tw, mask=mask, glob=True)
        err, cos = compare(got, want, dtype)
        errs.setdefault("tail", err)
        parts.append(f"mfa_astp {str(dtype)[6:]} T={t} "
                     f"{'masked' if masked else 'unmasked'} "
                     f"max_abs_err={err:.3g} cos={cos:.7f}")
    print("kernels: " + "; ".join(parts))
    return errs


def phase_slice(model, dev):
    rng = np.random.default_rng(SEED + 1)
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (SLICE_BATCH, CHUNK_SAMPLES))
                          .astype(np.float32), device=dev)
    embed = make_eval_embed_fn(model, FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16, device=dev)
    se_block.fused_se_res2_block.launches = 0
    mfa_astp.fused_mfa_astp.launches = 0
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = {"se": se_block.fused_se_res2_block.launches,
                "tail": mfa_astp.fused_mfa_astp.launches}
    if launches != {"se": 3, "tail": 1}:
        raise AssertionError(f"main path launches {launches}, want SE 3 "
                             "and tail 1 per forward")
    assert emb.shape == (SLICE_BATCH, 192) and torch.isfinite(emb).all()
    plain = make_eval_embed_fn(model.set_fused(False), FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16,
                               device=dev)({"wav": wav})
    f32 = make_eval_embed_fn(model, FbankConfig(), device=dev)({"wav": wav})
    model.set_fused(True)
    cos = row_cosines(emb, plain).min().item()
    cos32 = row_cosines(emb, f32).min().item()
    if cos < 0.9999:
        raise AssertionError(f"kernel path vs plain path cosine {cos}")
    print(f"slice: ECAPA_TDNN_GLOB_c512 bf16 B={SLICE_BATCH} x "
          f"{CHUNK_SAMPLES} samples -> {tuple(emb.shape)}; launches "
          f"se={launches['se']} tail={launches['tail']}; min cosine vs "
          f"plain bf16 path {cos:.7f}, vs plain f32 path {cos32:.7f}")
    return launches


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def phase_serving(model, dev):
    rng = np.random.default_rng(SEED + 2)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
            for n in (16000, 20800, 27200, 35200, 41600, 48000)]
    config = {"model": "ECAPA_TDNN_GLOB_c512",
              "model_args": {"feat_dim": 80, "embed_dim": 192}}
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "model.pt")
        torch.save(model.state_dict(), ckpt)
        server = EmbeddingServer(config, ckpt, port=0, max_batch=8,
                                 max_wait_ms=50, device=dev).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
                assert json.load(r)["status"] == "ok"
            se_block.fused_se_res2_block.launches = 0
            mfa_astp.fused_mfa_astp.launches = 0
            with concurrent.futures.ThreadPoolExecutor(len(wavs)) as ex:
                replies = list(ex.map(
                    lambda w: _post(f"{url}/embed", {"wav": w.tolist(),
                                                     "sample_rate": 16000}),
                    wavs))
            sim = _post(f"{url}/similarity",
                        {"wav1": wavs[0].tolist(), "wav2": wavs[3].tolist()})
            launches = {"se": se_block.fused_se_res2_block.launches,
                        "tail": mfa_astp.fused_mfa_astp.launches}
        finally:
            server.close()
    if min(launches.values()) < 1:
        raise AssertionError(f"serving did not reach the kernels: {launches}")
    single = make_eval_embed_fn(model, FbankConfig(), device=dev)
    cos, refs = [], []
    for w, rep in zip(wavs, replies):
        ref = single({"wav": w[None]})[0].cpu()
        refs.append(ref)
        cos.append(cosine(torch.tensor(rep["embedding"]), ref))
    if min(cos) < 0.9999:
        raise AssertionError(f"served replies vs batch=1: {cos}")
    want_sim = (cosine(refs[0], refs[3]) + 1) / 2
    if abs(sim["similarity"] - want_sim) > 1e-3:
        raise AssertionError(f"similarity {sim} vs {want_sim}")
    print(f"serving: {len(wavs)} concurrent /embed (1-3 s) + /similarity; "
          f"launches se={launches['se']} tail={launches['tail']}; min "
          f"cosine vs batch=1 {min(cos):.7f}; similarity "
          f"{sim['similarity']:.6f} (batch=1 {want_sim:.6f})")


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _nbytes(tensors, io):
    """Bytes of the operands as the kernel reads them: activations and
    matrices in the io type, biases and affines in f32."""
    return sum(v.numel() * (io.itemsize if v.dim() >= 2 else 4)
               for v in tensors)


def phase_timing(model, dev, smi):
    rng = np.random.default_rng(SEED + 3)
    io = torch.bfloat16
    m = B * T
    x, w, dil = se_inputs(model, rng, B, T, io, dev)
    width, nums = C // 8, 7
    se_flops = (2 * 2 * m * C * C + 2 * nums * m * 3 * width * width
                + 2 * 2 * B * C * 128)
    se_bytes = 2 * x.numel() * io.itemsize + _nbytes(w, io)
    res = {"se": {"ms": cuda_ms(lambda: se_block.fused_se_res2_block(
        x, *w, dilation=dil)),
        "plain_ms": cuda_ms(lambda: se_block.se_res2_block_reference(
            x, *w, dilation=dil), iters=5)}}
    res["se"]["bound_ms"], res["se"]["bound_by"] = bound(se_flops, se_bytes)
    del x
    xs, tw = tail_inputs(model, rng, B, T, io, dev)
    d, a = 1536, 128
    tail_flops = 2 * m * 3 * C * d + 2 * 2 * m * d * a + 2 * B * 2 * d * a
    tail_bytes = (3 * xs[0].numel() * io.itemsize + _nbytes(tw, io)
                  + B * 2 * d * 4)
    res["tail"] = {"ms": cuda_ms(lambda: mfa_astp.fused_mfa_astp(
        *xs, *tw, glob=True)),
        "plain_ms": cuda_ms(lambda: mfa_astp.mfa_astp_reference(
            *xs, *tw, glob=True), iters=5)}
    res["tail"]["bound_ms"], res["tail"]["bound_by"] = bound(tail_flops,
                                                             tail_bytes)
    del xs
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, CHUNK_SAMPLES)).astype(
        np.float32), device=dev)
    rates = {}
    for path, fused in (("kernel", True), ("plain", False)):
        embed = make_eval_embed_fn(model.set_fused(fused), FbankConfig(),
                                   compute_dtype=io, fbank_conv_dtype=io,
                                   device=dev)
        ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
        rates[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms)
    model.set_fused(True)
    fmt = "; ".join(
        f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, bound "
        f"{v['bound_ms']:.3f} by {v['bound_by']})" for k, v in res.items())
    print(f"timing [{smi}] B={B} T={T} C={C} bf16: {fmt}; extraction "
          f"kernel path {rates['kernel'][0]:.1f} audio-s/s "
          f"({rates['kernel'][1]:.2f} ms/batch), plain path "
          f"{rates['plain'][0]:.1f} audio-s/s ({rates['plain'][1]:.2f} "
          f"ms/batch)")
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the plain versions are exact f32 where they run in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device()
    model = random_model(dev)
    errs = phase_kernels(model, dev)
    launches = phase_slice(model, dev)
    phase_serving(model, dev)
    timing = phase_timing(model, dev, smi)
    rows = [("fused_se_res2_block", "se", "wespeaker_tpu_torch/csrc/se_block.cu",
             "wespeaker_tpu/ops/se_block_pallas.py:204"),
            ("fused_mfa_astp", "tail", "wespeaker_tpu_torch/csrc/mfa_astp.cu",
             "wespeaker_tpu/ops/mfa_astp_pallas.py:191")]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": timing[k]["ms"], "plain_ms": timing[k]["plain_ms"],
         "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"], "library_ms": None}
        for name, k, src, rep in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
