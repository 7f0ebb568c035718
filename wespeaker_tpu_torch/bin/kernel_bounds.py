"""Least time an H100 could take for the SE-Res2 block and the Res2 chain
(PERF.md rows 1 and 3) at ECAPA_TDNN_GLOB_c512's extraction shape, its
MFA+ASTP tail (row 2) there and the training tail's forward (row 4) at
bench.py's train batch, the
CAM++ dense block (row 8) at CAMPPlus's three blocks, the
statistics-pooling kernels (rows 6 and 7) on the paths that run them
(ReDimNetB2's ASTP with global context, and ResNet34's TSTP), and the
Gemini stage kernel (row 9) at each of Gemini_DF_ResNet114's four stages.
Rows 1 and 8 also print the floor of the port's design, which keeps
activations the TPU kernel held in VMEM in device memory: the bytes that
design must move over 3.35 TB/s; rows 2 and 4 the floor of their chain of
launches, the sum of each launch's own bound (`mfa_astp_tail_floor`), and
the training tail's backward (row 5) the same for its launches
(`mfa_astp_tail_bwd_floor`).

    python -m wespeaker_tpu_torch.bin.kernel_bounds

A bound is the larger of two times: the operations over the card's peak
rate for their type, and the bytes the function must move (each input read
once, each output written once) over the memory rate. Rates are the H100
SXM data sheet's dense ones: 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them, 3.35 TB/s. Activations and matrices are bf16
(the compute type of the configurations below), per-channel vectors and
f32 outputs 4 bytes. Products count a multiply-add as two operations and
only the live work (a CAM layer's zero-padded input rows, a segment's
repeated context, are not counted); the stats kernels count their f32
operations per element. chip_smoke.py computes every kernel's bound from
its own inputs with the same `bound` (with `mfa_astp_tail`, `res2_chain`,
`cam_dense_block`, `inv_bottleneck_stage`, `dw_pack`, `softmax_stats` and
`masked_stats` for the kernels they name).
"""

import math

from wespeaker_tpu_torch.ops.gemm_sm90 import tn_splits

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BF16, F32 = 2, 4


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "operations" or "bytes"): the larger of flops / peak and
    nbytes / PEAK_BYTES."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def res2_chain(b, t, c, scale=8):
    """ops/res2_pallas.py::fused_res2_chain on (B, T, C): scale - 1 k=3
    convs of width C/scale, BN folded. -> (flops, bytes)."""
    w, nums = c // scale, scale - 1
    flops = 2 * nums * b * t * 3 * w * w
    nbytes = 2 * b * t * c * BF16 + nums * (3 * w * w * BF16 + 3 * w * F32)
    return flops, nbytes


def softmax_stats(b, t, d, logit_bytes=BF16, x_bytes=BF16, masked=False):
    """ops/pooling_pallas.py::fused_softmax_stats: logits and x (B, T, D),
    an optional (B, T) f32 mask -> mean, std (B, D) f32; ~8 f32 operations
    per element (max, exp, three products, three sums)."""
    return (8 * b * t * d, b * t * (d * (logit_bytes + x_bytes)
                                     + (F32 if masked else 0))
            + 2 * b * d * F32)


def masked_stats(b, t, d, x_bytes=BF16, masked=True):
    """ops/pooling_pallas.py::fused_masked_stats: x (B, T, D) and an
    optional (B, T) f32 mask -> mean, std (B, D) f32; ~6 f32 operations
    per element."""
    return (6 * b * t * d,
            b * t * (d * x_bytes + (F32 if masked else 0)) + 2 * b * d * F32)


def cam_dense_block(b, t, c0, num_layers, seg_len=100, growth=32, bn=128):
    """ops/cam_block_pallas.py::fused_cam_dense_block: layer i takes the
    C0 + 32 i live channels through BN-relu, a 1x1 conv to 128, BN-relu, a
    k=3 conv to 32 and a CAM gate (128 -> 64 -> 32) computed once per
    segment; (B, T, C0) -> (B, T, C0 + 32 L)."""
    m, nseg = b * t, math.ceil(t / seg_len)
    flops = nbytes = 0
    for i in range(num_layers):
        ci = c0 + growth * i
        flops += (2 * m * ci * bn + 2 * m * 3 * bn * growth
                  + 2 * b * nseg * (bn * 64 + 64 * growth))
        nbytes += ((ci * bn + 3 * bn * growth + bn * 64 + 64 * growth) * BF16
                   + (2 * ci + 2 * bn + 64 + growth) * F32)
    nbytes += b * t * (2 * c0 + growth * num_layers) * BF16
    return flops, nbytes


def se_res2_block(b, t, c, scale=8, se=128):
    """ops/se_block_pallas.py::fused_se_res2_block on (B, T, C): two 1x1
    convs C -> C, the Res2 chain (`res2_chain`), the SE MLP C -> 128 -> C
    once an utterance, BN folded. -> (flops, bytes): x read once, out
    written once, the weights and affines once."""
    m, w, nums = b * t, c // scale, scale - 1
    flops = (2 * 2 * m * c * c + res2_chain(b, t, c, scale)[0]
             + 2 * 2 * b * c * se)
    nbytes = (2 * m * c * BF16 + (2 * c * c + nums * 3 * w * w + 2 * c * se)
              * BF16 + (6 * c + 3 * nums * w + se + c) * F32)
    return flops, nbytes


def se_res2_block_floor(b, t, c):
    """Bytes the port's design moves in device memory for one call: x read
    by the first GEMM and by the residual, h1, y and h2 each written once
    and read once, out written: 9 (B, T, C) bf16 maps (the TPU kernel kept
    h1, y and h2 in VMEM)."""
    return 9 * b * t * c * BF16


def cam_dense_block_floor(b, t, c0, num_layers, growth=32):
    """Bytes the port's design must read for one call: each layer reads
    its ci live channels of the dense map from device memory, sum of
    M ci 2 (the TPU kernel read the map once from VMEM)."""
    return sum(b * t * (c0 + growth * i) * BF16 for i in range(num_layers))


def _bytes_floor(nbytes):
    return (nbytes / PEAK_BYTES * 1e3,
            f"{nbytes / 1e9:.3f} GB in device memory")


def inv_bottleneck_stage(b, f, t, c, depth):
    """ops/inv_bottleneck_pallas.py::fused_inv_bottleneck_stage on
    (B, F, T, C): per block a 1x1 expand to 4C, a depthwise 3x3, a 1x1
    project to C and the residual, BN folded."""
    p = b * f * t
    flops = depth * (2 * 2 * p * c * 4 * c + 2 * p * 9 * 4 * c)
    nbytes = (2 * p * c * BF16
              + depth * ((2 * 4 * c * c + 9 * 4 * c) * BF16
                         + (4 * 4 * c + 2 * c) * F32))
    return flops, nbytes


def dw_pack(b, h, w, ci, co):
    """ops/conv_dw_pack.py::dw_pack: the filter gradient of a 3x3 stride-1
    conv, x (B, H, W, Ci) and dy (B, H, W, Co) bf16 -> (3, 3, Ci, Co) f32."""
    return (2 * b * h * w * 9 * ci * co,
            b * h * w * (ci + co) * BF16 + 9 * ci * co * F32)


def mfa_astp_tail(b, t, c, d=1536, a=128, train=False):
    """ops/mfa_astp_pallas.py::fused_mfa_astp (row 2) or, with `train`,
    ops/mfa_astp_vjp.py::_fwd_values (row 4) on x2, x3, x4 (B, T, C): the
    MFA conv (3C -> D), the attention and logits products (D -> A -> D)
    and the context product (2D -> A) once an utterance; reads x and the
    weights, writes pooled (B, 2D) f32, and in training also the residuals
    h, att (bf16) and cstats (B, 2D) f32."""
    m = b * t
    flops = 2 * m * 3 * c * d + 2 * 2 * m * d * a + 2 * b * 2 * d * a
    nbytes = (3 * m * c * BF16 + (3 * c * d + 3 * d * a + a * d) * BF16
              + (2 * d + a) * F32 + b * 2 * d * F32)
    if train:
        nbytes += m * (d + a) * BF16 + b * 2 * d * F32
    return flops, nbytes


def mfa_astp_tail_bwd(b, t, c, d=1536, a=128):
    """ops/mfa_astp_vjp.py::_bwd_pallas (row 5): the logits recomputed,
    datt, dh_att, dk2 and dk1x (five products of 2 M D A), dx and dwm (two
    of 2 M 3C D), the context products dcms and dk1's context rows; reads
    x, h, att, pooled, cstats, g and the weights, writes dx (bf16) and the
    f32 weight gradients."""
    m = b * t
    flops = 5 * 2 * m * d * a + 2 * 2 * m * 3 * c * d + 2 * 2 * b * 2 * d * a
    nbytes = (2 * 3 * m * c * BF16 + m * (d + a) * BF16 + 3 * b * 2 * d * F32
              + (3 * c * d + 3 * d * a + a * d) * BF16 + d * F32
              + (3 * c * d + 3 * d * a + a * d + 2 * d + a) * F32)
    return flops, nbytes


def mfa_astp_tail_floor(b, t, c, d=1536, a=128):
    """The floor of the port's bf16 chain for rows 2 and 4
    (csrc/mfa_astp_fwd.cuh): h, att and the f32 logits pass through device
    memory, so each launch has its own bound, and the floor is their sum.
    -> [(launch, ms, "operations" or "bytes")]."""
    m = b * t
    steps = [
        ("mfa_gemm", 2 * m * 3 * c * d,
         3 * m * c * BF16 + 3 * c * d * BF16 + m * d * BF16),
        ("ctx_stats", 3 * m * d, m * d * BF16 + b * 2 * d * BF16),
        ("ctx_gemm", 2 * b * 2 * d * a,
         b * 2 * d * BF16 + 2 * d * a * BF16 + b * a * F32),
        ("tanh_gemm", 2 * m * d * a,
         m * d * BF16 + d * a * BF16 + m * a * BF16),
        ("logits_gemm", 2 * m * a * d,
         m * a * BF16 + a * d * BF16 + m * d * F32),
        ("softmax_stats", 8 * m * d, m * d * (F32 + BF16) + b * 2 * d * F32),
    ]
    out = []
    for name, flops, nbytes in steps:
        peak = (PEAK_F32_FLOPS if name in ("ctx_stats", "softmax_stats")
                else PEAK_BF16_FLOPS)
        out.append((name, *bound(flops, nbytes, peak)))
    return out


def mfa_astp_tail_bwd_floor(b, t, c, d=1536, a=128):
    """The floor of the port's bf16 backward for row 5
    (csrc/mfa_astp_train.cu, ws_mfa_astp_train_bwd_sm90): the f32 logits,
    dlogits, dh_pool, dpre and dacc pass through device memory, so each
    launch has its own bound, and the floor is their sum (the weight
    gradients are one launch, then the fixed-order sum of the f32 slabs of
    the K splits that launch makes, `tn_splits` of its 128 x 128 tiles; the
    partial-sum readers move under 10 MB and are left out).
    -> [(launch, ms, "operations" or "bytes")]."""
    m = b * t
    wgrad = 3 * c * d + 2 * a * d  # f32 elements of dwm, dk2, dk1x
    tiles = ((-(-3 * c // 128)) * -(-d // 128)
             + 2 * -(-a // 128) * -(-d // 128))  # dwm, then dk2 and dk1x
    splits, _ = tn_splits(tiles, -(-m // 64))
    steps = [
        ("logits_gemm", 2 * m * a * d,
         m * a * BF16 + a * d * BF16 + m * d * F32),
        # read the f32 logits and h, write dlogits (bf16) and dh_pool (f32)
        ("softmax_bwd", 12 * m * d, m * d * (F32 + BF16 + BF16 + F32)),
        ("dpre_gemm", 2 * m * d * a,
         m * d * BF16 + a * d * BF16 + 2 * m * a * BF16),
        ("dcms_gemm", 2 * b * a * 2 * d,
         b * a * BF16 + 2 * d * a * BF16 + b * 2 * d * F32),
        # read dpre, h and dh_pool, write dacc
        ("dacc_gemm", 2 * m * a * d,
         m * a * BF16 + d * a * BF16 + m * d * (BF16 + F32 + BF16)),
        ("dx_gemm", 2 * m * d * 3 * c,
         m * d * BF16 + 3 * c * d * BF16 + m * 3 * c * BF16),
        # x2, x3, x4, dacc, att, dlogits, h and dpre read once
        ("weight_grads", 2 * m * (3 * c * d + 2 * a * d),
         m * (3 * c + 3 * d + 2 * a) * BF16 + wgrad * F32),
        ("splitk_sum", splits * wgrad, (splits + 1) * wgrad * F32),
    ]
    out = []
    for name, flops, nbytes in steps:
        peak = (PEAK_F32_FLOPS if name in ("softmax_bwd", "splitk_sum")
                else PEAK_BF16_FLOPS)
        out.append((name, *bound(flops, nbytes, peak)))
    return out


def _tail_floor(b, t, c, steps=None):
    steps = steps or mfa_astp_tail_floor(b, t, c)
    return (sum(ms for _, ms, _ in steps), "the sum of its launches' "
            + ", ".join(f"{n} {ms:.3f}" for n, ms, _ in steps))


CAMPPLUS_BLOCKS = ((128, 12), (256, 24), (512, 16))  # (C0, layers) at T'=100

# (PERF.md row, kernel, configuration, [(call, flops, bytes, peak)], the
# floor of the port's design as (ms, what it is) or None)
ROWS = [
    (6, "fused_softmax_stats",
     "ASTP of ReDimNetB2, B=512 x 200 frames, D=16*72=1152, bf16 logits "
     "and x, with a mask",
     [("call", *softmax_stats(512, 200, 1152, masked=True),
       PEAK_F32_FLOPS)], None),
    (6, "fused_softmax_stats",
     "the same with f32 logits",
     [("call", *softmax_stats(512, 200, 1152, logit_bytes=F32, masked=True),
       PEAK_F32_FLOPS)], None),
    (7, "fused_masked_stats",
     "ASTP global context of ReDimNetB2, B=512 x 200 frames, D=1152, "
     "with a mask",
     [("call", *masked_stats(512, 200, 1152), PEAK_F32_FLOPS)], None),
    (7, "fused_masked_stats",
     "TSTP of ResNet34, B=512 x 200 frames: T=25, D=32*8*10=2560, with a "
     "mask",
     [("call", *masked_stats(512, 25, 2560), PEAK_F32_FLOPS)], None),
] + [
    (9, "fused_inv_bottleneck_stage",
     f"Gemini_DF_ResNet114 stage {i}, B=512 x 200 frames: (F, T, C) = "
     f"({f}, {t}, {c}), {depth} blocks",
     [("call", *inv_bottleneck_stage(512, f, t, c, depth), PEAK_BF16_FLOPS)],
     None)
    for i, (f, t, c, depth) in enumerate(
        ((40, 200, 32, 3), (20, 100, 64, 3), (10, 100, 128, 27),
         (5, 100, 256, 3)))
] + [
    (1, "fused_se_res2_block",
     "ECAPA_TDNN_GLOB_c512, B=512, T=200, C=512, bf16",
     [("call", *se_res2_block(512, 200, 512), PEAK_BF16_FLOPS)],
     _bytes_floor(se_res2_block_floor(512, 200, 512))),
    (3, "fused_res2_chain",
     "ECAPA_TDNN_GLOB_c512's chain, B=512, T=200, C=512 (width 64), bf16",
     [("call", *res2_chain(512, 200, 512), PEAK_BF16_FLOPS)], None),
    (8, "fused_cam_dense_block",
     "CAMPPlus's three blocks, B=512 x 200 frames (T'=100), bf16",
     [(f"block{i + 1}", *cam_dense_block(512, 100, c0, layers),
       PEAK_BF16_FLOPS) for i, (c0, layers) in enumerate(CAMPPLUS_BLOCKS)],
     _bytes_floor(sum(cam_dense_block_floor(512, 100, c0, layers)
                      for c0, layers in CAMPPLUS_BLOCKS))),
    (2, "fused_mfa_astp",
     "ECAPA_TDNN_GLOB_c512's tail, B=512, T=200, C=512, D=1536, A=128, "
     "bf16",
     [("call", *mfa_astp_tail(512, 200, 512), PEAK_BF16_FLOPS)],
     _tail_floor(512, 200, 512)),
    (4, "mfa_astp_train_fwd",
     "the training tail's forward, B=256, T=200, C=512, bf16",
     [("call", *mfa_astp_tail(256, 200, 512, train=True), PEAK_BF16_FLOPS)],
     _tail_floor(256, 200, 512)),
    (5, "mfa_astp_train_bwd",
     "the training tail's backward, B=256, T=200, C=512, bf16",
     [("call", *mfa_astp_tail_bwd(256, 200, 512), PEAK_BF16_FLOPS)],
     _tail_floor(256, 200, 512, mfa_astp_tail_bwd_floor(256, 200, 512))),
]


def main():
    for row, name, config, calls, floor in ROWS:
        parts, total = [], 0.0
        for call, flops, nbytes, peak in calls:
            ms, by = bound(flops, nbytes, peak)
            total += ms
            parts.append(f"{call} {ms:.4f} ms ({flops / 1e9:.2f} GFLOP, "
                         f"{nbytes / 1e6:.1f} MB; {by})")
        print(f"row {row} {name} [{config}]: " + "; ".join(parts)
              + (f"; total {total:.4f} ms" if len(calls) > 1 else "")
              + ("" if floor is None else
                 f"; the design's floor {floor[0]:.4f} ms ({floor[1]})"))


if __name__ == "__main__":
    main()
