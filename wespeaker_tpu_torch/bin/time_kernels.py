"""Time every ported CUDA kernel of the package it is run from, on the card.

    python -m wespeaker_tpu_torch.bin.time_kernels [--iters 50]

Each kernel runs at its main-path shape in bf16 on random operands made
from a seed (the SE-Res2 block and the MFA+ASTP tail at B=512, T=200,
C=512; the training tail's forward and backward at B=256; the three CAM++
dense blocks of one CAMPPlus forward at B=512, T'=100; the four stages of
one Gemini_DF_ResNet114 forward at B=512 x 200 frames, as `gemini` and per
stage as `gemini_s0` to `gemini_s3`, with the most device memory a stage
call takes beyond its input (its output and any workspace) as
`gemini_stage_extra_gib` and the peak device memory of one bf16 B=512 x
2 s Gemini_DF_ResNet114 forward as `gemini_forward_peak_gib`;
the Res2 chain of
one ECAPA c512 block at B=512, T=200; the 14 tap-packed dW calls of one
ResNet34 train step at B=128 x 200 frames: the stem, six layer1 and seven
layer2 convs, as `dw` and per call as `dw_stem`, `dw_32` and `dw_64`; the
two statistics-pooling kernels at ReDimNetB2's ASTP
shape, B=512 x 200 frames, D=1152, and the masked stats also at
ResNet34's TSTP shape, T'=25, D=2560), timed with CUDA events after
warm-up; the dw_pack and masked-stats keys by replaying a CUDA graph of
the calls, so that the wrapper's host time (about as long as the
masked stats at T'=25) does not hide the kernel. Prints the card and
one JSON line {kernel: ms} (`--only` limits it to the named ops
modules); `softmax_f32` is row 6 with f32 logits (the ECAPA tail's
form). `--split` also prints, for one call of the SE-Res2 block, of
the MFA+ASTP tail (B=512), of the training tail's forward and backward
(B=256), of the Res2 chain, of each CAM++ block and of the
softmax-weighted stats (bf16 and f32 logits), the device time of every
CUDA kernel it launches (torch.profiler, `profile_extract.breakdown`).
`--gemm` times instead the bf16 GEMM of rows 1 and 8 alone
(`ops/gemm_sm90.py`, CUDA-graph replay): at the CAM++ bottleneck's shape
(M = 512 x 100 rows of a 1024-channel map, K = 128, 512, 992, N = 128) in
the bn_relu form with and without the partial sums and in the post form,
at M = 67,584 (whole waves of 128-row tiles on 132 SMs) for K = 992, and
at the SE block's (M = 512 x 200, K = N = 512) in the post form.
`--digest` prints a digest of the output bits of one call of rows 1, 2,
3, 4 and 8 on the seeded inputs, and of rows 2 and 4's f32 routes at
B=16, T=198 (row 2 masked), so two trees give the same bits where the
digests match. A kernel the package does not have is left out, so the
same file times an older checkout: run it with that checkout first on
PYTHONPATH to compare two trees in one call (old, new, new, old).
"""

import argparse
import hashlib
import importlib
import json

import numpy as np
import torch

from wespeaker_tpu_torch.device import resolve_device


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms per call: `iters` calls captured in a CUDA graph and its
    replay timed with CUDA events, so a wrapper's host time (tens of
    microseconds, as long as a short kernel) cannot hide the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Gemini_DF_ResNet114's stages at 200 frames, (F, T, C, blocks)
GEMINI_STAGES = ((40, 200, 32, 3), (20, 100, 64, 3), (10, 100, 128, 27),
                 (5, 100, 256, 3))


def gemini_forward_peak_gib(dev) -> float:
    """Peak device memory (GiB, torch.cuda.max_memory_allocated after a
    reset) of one B=512 x 2 s bf16 Gemini_DF_ResNet114 extraction forward
    (feat 80, embed 256, random weights from a seed)."""
    from wespeaker_tpu_torch.frontend.fbank import FbankConfig
    from wespeaker_tpu_torch.models.gemini_dfresnet import (
        Gemini_DF_ResNet114)
    from wespeaker_tpu_torch.train import make_eval_embed_fn

    torch.manual_seed(0)
    model = Gemini_DF_ResNet114(80, 256).to(dev).eval()
    embed = make_eval_embed_fn(model, FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16, device=dev)
    wav = torch.rand(512, (200 - 1) * 160 + 400, device=dev) - 0.5
    embed({"wav": wav})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    embed({"wav": wav})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, embed, wav
    torch.cuda.empty_cache()
    return peak


def time_gemm(r, iters):
    """ms of ops/gemm_sm90.py's GEMM by shape and form (`--gemm`)."""
    from wespeaker_tpu_torch.ops import gemm_sm90 as g9

    out = {}
    for name, m, lda, k, n in (
            ("cam_k128", 512 * 100, 1024, 128, 128),
            ("cam_k512", 512 * 100, 1024, 512, 128),
            ("cam_k992", 512 * 100, 1024, 992, 128),
            ("cam_k992_whole_waves", 132 * 4 * 128, 1024, 992, 128),
            ("se", 512 * 200, 512, 512, 512)):
        a = r(m, lda, dtype=torch.bfloat16)
        wt = r(n, k, scale=k ** -0.5, dtype=torch.bfloat16)
        sc, sh, bias = 1 + r(n, scale=.1), r(n, scale=.1), r(n, scale=.1)
        asc, ash = 1 + r(k, scale=.1), r(k, scale=.1)
        forms = {"post": dict(bias=bias)}
        if name != "se":
            forms = {"bn_relu_part": dict(a_scale=asc, a_shift=ash, t=100,
                                          seg_len=100),
                     "bn_relu": dict(a_scale=asc, a_shift=ash), **forms}
        for form, kw in forms.items():
            out[f"{name}_{form}"] = graph_ms(
                lambda: g9.gemm_sm90(a, k, wt, sc, sh, **kw), iters)
        del a
    return out


ONLY = None  # ops module names to time (--only), None for all


def _ops(name):
    if ONLY is not None and name not in ONLY:
        return None
    try:
        return importlib.import_module(f"wespeaker_tpu_torch.ops.{name}")
    except ModuleNotFoundError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--split", action="store_true",
                    help="also print each row 1, 2, 3, 4, 5, 6 and 8 "
                         "call's device time per kernel (torch.profiler)")
    ap.add_argument("--digest", action="store_true",
                    help="also print a digest of the output bits of rows "
                         "1, 2, 3, 4 and 8 on the seeded inputs")
    ap.add_argument("--gemm", action="store_true",
                    help="time the GEMM of rows 1 and 8 alone, by form")
    ap.add_argument("--only", default=None,
                    help="comma-separated ops modules to time (e.g. "
                         "inv_bottleneck,pooling); default all")
    args = ap.parse_args(argv)
    global ONLY
    ONLY = None if args.only is None else set(args.only.split(","))
    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    io = torch.bfloat16

    def r(*shape, scale=1.0, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=dev).to(dtype)

    def split(fn, what):
        if args.split:
            from wespeaker_tpu_torch.bin.profile_extract import breakdown
            breakdown(fn, what)

    digests = {}

    def digest(key, fn):
        """sha256 of one call's output bits (`--digest`): two trees agree
        bit for bit on the same seeded inputs where their digests match."""
        if args.digest:
            outs = fn()
            outs = outs if isinstance(outs, (tuple, list)) else [outs]
            h = hashlib.sha256()
            for v in outs:
                h.update(v.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            digests[key] = digests.get(key, "") + h.hexdigest()[:12]

    if args.gemm:
        print(torch.cuda.get_device_name(0))
        print(json.dumps(time_gemm(r, args.iters)))
        return

    out = {}
    b, t, c, d, a = 512, 200, 512, 1536, 128
    se = _ops("se_block")
    if se is not None:
        w = c // 8
        x = r(b, t, c, dtype=io)
        ws = (r(c, c, scale=c ** -0.5), r(c, scale=.1), 1 + r(c, scale=.1),
              r(c, scale=.1), r(7, 3, w, w, scale=(3 * w) ** -0.5),
              r(7, w, scale=.1), 1 + r(7, w, scale=.1), r(7, w, scale=.1),
              r(c, c, scale=c ** -0.5), r(c, scale=.1), 1 + r(c, scale=.1),
              r(c, scale=.1), r(c, 128, scale=c ** -0.5), r(128, scale=.1),
              r(128, c, scale=128 ** -0.5), r(c, scale=.1))
        out["se"] = cuda_ms(lambda: se.fused_se_res2_block(x, *ws,
                                                           dilation=3),
                            args.iters)
        split(lambda: se.fused_se_res2_block(x, *ws, dilation=3),
              f"row 1 fused_se_res2_block B={b} T={t} C={c} d=3 bf16")
        digest("se", lambda: se.fused_se_res2_block(x, *ws, dilation=3))
        del x
    tail_w = (r(3 * c, d, scale=(3 * c) ** -0.5), r(d, scale=.1),
              r(3 * d, a, scale=d ** -0.5), r(a, scale=.1),
              r(a, d, scale=a ** -0.5), r(d, scale=.1))
    tail = _ops("mfa_astp")
    if tail is not None:
        xs = [r(b, t, c, dtype=io) for _ in range(3)]
        out["tail"] = cuda_ms(lambda: tail.fused_mfa_astp(*xs, *tail_w,
                                                          glob=True),
                              args.iters)
        split(lambda: tail.fused_mfa_astp(*xs, *tail_w, glob=True),
              f"row 2 fused_mfa_astp B={b} T={t} C={c} glob bf16")
        digest("tail", lambda: tail.fused_mfa_astp(*xs, *tail_w, glob=True))
        del xs
        if args.digest:
            # and the f32 route, masked, at a ragged T
            xs = [r(16, 198, c) for _ in range(3)]
            mask = (torch.arange(198, device=dev)[None]
                    < torch.arange(198, 198 - 16 * 9, -9, device=dev)[:, None]
                    ).float()
            digest("tail_f32", lambda: tail.fused_mfa_astp(
                *xs, *tail_w, mask=mask, glob=True))
            del xs
    vjp = _ops("mfa_astp_vjp")
    if vjp is not None:
        xs = [r(256, t, c, dtype=io) for _ in range(3)]
        wm, bm, k1, b1, k2, b2 = tail_w
        pooled, h, att, cstats = vjp.mfa_astp_train_fwd(*xs, *tail_w)
        g = r(256, 2 * d)
        res = (*xs, wm, k1, b2, k2, pooled, h, att, cstats, g)
        out["train_fwd"] = cuda_ms(lambda: vjp.mfa_astp_train_fwd(*xs,
                                                                  *tail_w),
                                   args.iters)
        out["train_bwd"] = cuda_ms(lambda: vjp.mfa_astp_train_bwd(*res),
                                   args.iters)
        split(lambda: vjp.mfa_astp_train_fwd(*xs, *tail_w),
              f"row 4 mfa_astp_train_fwd B=256 T={t} C={c} glob bf16")
        split(lambda: vjp.mfa_astp_train_bwd(*res),
              f"row 5 mfa_astp_train_bwd B=256 T={t} C={c} glob bf16")
        digest("train_fwd", lambda: vjp.mfa_astp_train_fwd(*xs, *tail_w))
        del xs, res, pooled, h, att, cstats
        if args.digest:
            xs = [r(16, 198, c) for _ in range(3)]
            digest("train_fwd_f32", lambda: vjp.mfa_astp_train_fwd(*xs,
                                                                   *tail_w))
            del xs
    cam = _ops("cam_block")
    if cam is not None:
        total = 0.0
        for c0, layers, dil in ((128, 12, 1), (256, 24, 2), (512, 16, 2)):
            cend = c0 + 32 * layers
            live = (torch.arange(cend, device=dev)[None]
                    < (c0 + 32 * torch.arange(layers, device=dev))[:, None])
            ws = ((1 + r(layers, cend, scale=.1)) * live,
                  r(layers, cend, scale=.1) * live,
                  r(layers, cend, 128, scale=c0 ** -0.5) * live[..., None],
                  1 + r(layers, 128, scale=.1), r(layers, 128, scale=.1),
                  r(layers, 3, 128, 32, scale=384 ** -0.5),
                  r(layers, 128, 64, scale=128 ** -0.5),
                  r(layers, 64, scale=.1),
                  r(layers, 64, 32, scale=64 ** -0.5), r(layers, 32, scale=.1))
            x = r(b, 100, c0, dtype=io)
            total += cuda_ms(lambda: cam.fused_cam_dense_block(
                x, *ws, dilation=dil), args.iters)
            split(lambda: cam.fused_cam_dense_block(x, *ws, dilation=dil),
                  f"row 8 fused_cam_dense_block B={b} T'=100 C0={c0} "
                  f"L={layers} d={dil} bf16")
            digest("cam", lambda: cam.fused_cam_dense_block(x, *ws,
                                                            dilation=dil))
        out["cam"] = total
    inv = _ops("inv_bottleneck")
    if inv is not None:
        total = extra = 0.0
        for i, (f, tt, ch, blocks) in enumerate(GEMINI_STAGES):
            dd = 4 * ch
            ws = (r(blocks, ch, dd, scale=ch ** -0.5),
                  1 + r(blocks, dd, scale=.1), r(blocks, dd, scale=.1),
                  r(blocks, 3, 3, dd, scale=1 / 3),
                  1 + r(blocks, dd, scale=.1), r(blocks, dd, scale=.1),
                  r(blocks, dd, ch, scale=dd ** -0.5),
                  1 + r(blocks, ch, scale=.1), r(blocks, ch, scale=.1))
            x = r(b, f, tt, ch, dtype=io).permute(0, 3, 1, 2)
            out[f"gemini_s{i}"] = cuda_ms(
                lambda: inv.fused_inv_bottleneck_stage(x, *ws), args.iters)
            total += out[f"gemini_s{i}"]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            inv.fused_inv_bottleneck_stage(x, *ws)
            torch.cuda.synchronize()
            extra = max(extra, (torch.cuda.max_memory_allocated() - base)
                        / 2 ** 30)
            del x
        out["gemini"] = total
        out["gemini_stage_extra_gib"] = extra
        out["gemini_forward_peak_gib"] = gemini_forward_peak_gib(dev)
    res2 = _ops("res2_chain")
    if res2 is not None:
        w = c // 8
        x = r(b, t, c, dtype=io)
        ws = (r(7, 3, w, w, scale=(3 * w) ** -0.5), r(7, w, scale=.1),
              1 + r(7, w, scale=.1), r(7, w, scale=.1))
        out["res2"] = cuda_ms(lambda: res2.fused_res2_chain(x, *ws,
                                                            dilation=3),
                              args.iters)
        split(lambda: res2.fused_res2_chain(x, *ws, dilation=3),
              f"row 3 fused_res2_chain B={b} T={t} C={c} d=3 bf16")
        digest("res2", lambda: res2.fused_res2_chain(x, *ws, dilation=3))
        del x
    dw = _ops("conv_dw_pack")
    if dw is not None:
        total = 0.0
        for key, h, ww, ci, co, calls in (
                ("dw_stem", 80, 200, 1, 32, 1), ("dw_32", 80, 200, 32, 32, 6),
                ("dw_64", 40, 100, 64, 64, 7)):
            x, dy = r(128, h, ww, ci, dtype=io), r(128, h, ww, co, dtype=io)
            out[key] = graph_ms(lambda: dw.dw_pack(x, dy), args.iters)
            total += calls * out[key]
            del x, dy
        out["dw"] = total
    pool = _ops("pooling")
    if pool is not None:
        logits, x = r(b, t, 1152, dtype=io), r(b, t, 1152, dtype=io)
        out["softmax"] = cuda_ms(lambda: pool.fused_softmax_stats(logits, x),
                                 args.iters)
        split(lambda: pool.fused_softmax_stats(logits, x),
              f"row 6 fused_softmax_stats B={b} T={t} D=1152 bf16")
        logits = logits.float()
        out["softmax_f32"] = cuda_ms(
            lambda: pool.fused_softmax_stats(logits, x), args.iters)
        split(lambda: pool.fused_softmax_stats(logits, x),
              f"row 6 fused_softmax_stats B={b} T={t} D=1152 f32 logits")
        out["masked"] = graph_ms(lambda: pool.fused_masked_stats(x),
                                 args.iters)
        del logits, x
        x = r(b, 25, 2560, dtype=io)
        out["masked_tstp"] = graph_ms(lambda: pool.fused_masked_stats(x),
                                      args.iters)
        del x
    print(torch.cuda.get_device_name(0))
    if digests:
        print("digests " + json.dumps(digests))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
