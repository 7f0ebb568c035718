"""The bounds that PERF.md's kernel table gives the TPU kernels
(wespeaker_tpu_torch/bin/kernel_bounds.py: the SE-Res2 block, the Res2
chain and the CAM++ blocks with the floors of the port's design, the
statistics-pooling rows at their paths' shapes, the Gemini stage per
stage, and the counts chip_smoke.py takes for every kernel): the
arithmetic on shapes whose counts are known by hand."""

import pytest

from wespeaker_tpu_torch.bin import kernel_bounds as kb
from wespeaker_tpu_torch.ops import gemm_sm90 as g9


@pytest.mark.parametrize("flops,nbytes,want", [
    (989e9, 1.0, (1.0, "operations")),
    (1.0, 3.35e9, (1.0, "bytes")),
])
def test_bound_is_the_larger_time(flops, nbytes, want):
    ms, by = kb.bound(flops, nbytes)
    assert ms == pytest.approx(want[0]) and by == want[1]


def test_counts_by_hand():
    # the Res2 chain of one ECAPA c512 block at B=512, T=200: 7 k=3 convs
    # of width 64
    flops, nbytes = kb.res2_chain(512, 200, 512)
    assert flops == 2 * 7 * 512 * 200 * 3 * 64 * 64
    assert nbytes > 2 * 512 * 200 * 512 * 2
    # one CAM layer on 128 channels, T=100: 1x1 to 128, k=3 to 32, and the
    # gate once per segment
    flops, _ = kb.cam_dense_block(2, 100, 128, 1)
    assert flops == (2 * 200 * 128 * 128 + 2 * 200 * 3 * 128 * 32
                     + 2 * 2 * (128 * 64 + 64 * 32))
    flops, nbytes = kb.dw_pack(1, 4, 5, 2, 3)
    assert flops == 2 * 20 * 9 * 6 and nbytes == 20 * 5 * 2 + 9 * 6 * 4


def test_cam_block_counts_by_hand():
    # CAMPPlus block1 at B=512, T'=100: 12 layers on 128 + 32 i channels,
    # each a 1x1 to 128, a k=3 conv to 32 and the gate once per segment
    flops, nbytes = kb.cam_dense_block(512, 100, 128, 12)
    m = 512 * 100
    k_sum = sum(128 + 32 * i for i in range(12))   # 3648
    assert k_sum == 3648
    assert flops == (2 * m * 128 * k_sum + 12 * 2 * m * 3 * 128 * 32
                     + 12 * 2 * 512 * (128 * 64 + 64 * 32))
    assert round(flops / 1e9) == 63
    # x read once (128 channels), out written once (128 + 384)
    assert nbytes > m * (128 + 512) * 2


def test_se_block_and_cam_floors_by_hand():
    # row 1 at B=512, T=200, C=512: two 512 x 512 products (107.4 GFLOP),
    # the chain (17.6) and the SE MLP (0.13): 125.1 GFLOP, 0.127 ms at 989
    # TFLOP/s; the design moves 9 maps of 104.9 MB
    flops, nbytes = kb.se_res2_block(512, 200, 512)
    m = 512 * 200
    assert flops == (2 * 2 * m * 512 * 512 + 2 * 7 * m * 3 * 64 * 64
                     + 2 * 2 * 512 * 512 * 128)
    assert round(flops / 1e8) == 1251
    ms, by = kb.bound(flops, nbytes)
    assert round(ms, 3) == 0.127 and by == "operations"
    assert kb.se_res2_block_floor(512, 200, 512) == 9 * m * 512 * 2
    # row 8: the three CAMPPlus blocks, 468 GFLOP; each layer reads its live
    # channels, sum of M ci 2 = 3.14 GB (>= 0.94 ms at 3.35 TB/s)
    flops = sum(kb.cam_dense_block(512, 100, c0, n)[0]
                for c0, n in kb.CAMPPLUS_BLOCKS)
    assert round(flops / 1e9) == 468
    floor = sum(kb.cam_dense_block_floor(512, 100, c0, n)
                for c0, n in kb.CAMPPLUS_BLOCKS)
    k_sum = (sum(128 + 32 * i for i in range(12))
             + sum(256 + 32 * i for i in range(24))
             + sum(512 + 32 * i for i in range(16)))
    assert k_sum == 30656
    assert floor == 512 * 100 * k_sum * 2
    assert round(floor / 1e9, 2) == 3.14
    assert round(floor / kb.PEAK_BYTES * 1e3, 2) == 0.94


def test_every_unported_row_has_a_bound(capsys):
    """Every row a path runs at its main-path shape: the pooling rows (6, 7)
    at the shapes of the paths that run them, row 9 once a Gemini stage,
    rows 1 and 3 at ECAPA's and row 8 at CAMPPlus's three blocks, rows 2,
    4 and 5 at ECAPA's extraction and train batches (rows 1, 8, 2, 4 and 5
    with the design's floor)."""
    kb.main()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["6", "6", "7", "7", "9", "9",
                                              "9", "9", "1", "3", "8", "2",
                                              "4", "5"]
    assert all(" ms (" in ln for ln in lines)
    assert [("floor" in ln) for ln in lines[-6:]] == [True, False, True,
                                                      True, True, True]


def test_mfa_astp_tail_counts_by_hand():
    # row 2 at B=512, T=200, C=512, D=1536, A=128: the MFA conv 2 * M * 3C
    # * D = 483.2 GFLOP, the attention and logits products 40.3 each, the
    # context product once an utterance 0.4: 564.1 GFLOP, 0.570 ms at 989
    # TFLOP/s; x read once (314.6 MB)
    m = 512 * 200
    flops, nbytes = kb.mfa_astp_tail(512, 200, 512)
    assert flops == (2 * m * 1536 * 1536 + 2 * 2 * m * 1536 * 128
                     + 2 * 512 * 3072 * 128)
    assert round(flops / 1e9, 1) == 564.1
    assert nbytes == (3 * m * 512 * 2 + (1536 * 1536 + 3 * 1536 * 128
                                         + 128 * 1536) * 2
                      + (2 * 1536 + 128) * 4 + 512 * 3072 * 4)
    ms, by = kb.bound(flops, nbytes)
    assert round(ms, 3) == 0.570 and by == "operations"
    # row 4 at B=256 also writes h, att and cstats
    f4, b4 = kb.mfa_astp_tail(256, 200, 512, train=True)
    m4 = 256 * 200
    assert f4 * 2 == flops
    assert b4 - kb.mfa_astp_tail(256, 200, 512)[1] == (
        m4 * (1536 + 128) * 2 + 256 * 3072 * 4)
    assert round(kb.bound(f4, b4)[0], 3) == 0.285
    # the chain's floor: the MFA GEMM by operations, the rest by bytes:
    # h read by the stats (315 MB) and the tanh GEMM (+ att), the f32
    # logits written (629 MB) and read with h by softmax_stats
    steps = dict((n, (ms, by)) for n, ms, by in
                 kb.mfa_astp_tail_floor(512, 200, 512))
    assert steps["mfa_gemm"] == (pytest.approx(483.2e9 / 989e12 * 1e3,
                                               rel=1e-3), "operations")
    assert steps["logits_gemm"][1] == "bytes"
    assert steps["logits_gemm"][0] == pytest.approx(
        (m * 128 * 2 + 128 * 1536 * 2 + m * 1536 * 4) / 3.35e9)
    assert steps["softmax_stats"][0] == pytest.approx(
        (m * 1536 * 6 + 512 * 3072 * 4) / 3.35e9)
    total = sum(ms for ms, _ in steps.values())
    assert round(total, 2) == 1.17
    # row 5 at B=256: five products of 2 M D A and two of 2 M 3C D
    f5, _ = kb.mfa_astp_tail_bwd(256, 200, 512)
    assert f5 == (5 * 2 * m4 * 1536 * 128 + 2 * 2 * m4 * 1536 * 1536
                  + 2 * 2 * 256 * 3072 * 128)
    assert round(kb.bound(*kb.mfa_astp_tail_bwd(256, 200, 512))[0],
                 3) == 0.591


@pytest.mark.parametrize("stage,shape,want_ms", [
    # (F, T, C, blocks) at B=512 x 200 frames; per block 2 * 2 * P * C * 4C
    # for the two 1x1 products and 2 * P * 9 * 4C for the depthwise, P =
    # 512 F T positions: 3 * (2 * 2 * 4.096e6 * 32 * 128 + 2 * 4.096e6 *
    # 9 * 128) = 229.6 GFLOP at stage 0, 0.232 ms at 989 TFLOP/s
    (0, (40, 200, 32, 3), 0.232),
    (1, (20, 100, 64, 3), 0.218),
    (2, (10, 100, 128, 27), 3.793),
    (3, (5, 100, 256, 3), 0.829),
])
def test_gemini_stage_bounds_by_hand(stage, shape, want_ms):
    f, t, c, depth = shape
    p = 512 * f * t
    flops = depth * (2 * 2 * p * c * 4 * c + 2 * p * 9 * 4 * c)
    assert kb.inv_bottleneck_stage(512, *shape)[0] == flops
    assert kb.ROWS[4 + stage][0] == 9 and f"({f}, {t}, {c})" in kb.ROWS[
        4 + stage][2]
    _, row_flops, row_bytes, peak = kb.ROWS[4 + stage][3][0]
    ms, by = kb.bound(row_flops, row_bytes, peak)
    assert by == "operations" and round(ms, 3) == want_ms
    assert round(flops / 989e12 * 1e3, 3) == want_ms


def test_pooling_bounds_by_hand():
    # ReDimNetB2's ASTP at B=512 x 200 frames, D = 16 * 72 = 1152: row 6
    # reads bf16 logits and x once (f32 logits: 6 bytes an element), row 7
    # x once; both write (B, 2D) f32; both bound by bytes
    m = 512 * 200
    flops, nbytes = kb.softmax_stats(512, 200, 1152)
    assert nbytes == m * 1152 * 4 + 512 * 2 * 1152 * 4
    ms, by = kb.bound(flops, nbytes, kb.PEAK_F32_FLOPS)
    assert by == "bytes" and round(ms, 3) == 0.142
    ms, _ = kb.bound(*kb.softmax_stats(512, 200, 1152, logit_bytes=4),
                     kb.PEAK_F32_FLOPS)
    assert round(ms, 3) == 0.213
    flops, nbytes = kb.masked_stats(512, 200, 1152)
    assert nbytes == m * (1152 * 2 + 4) + 512 * 2 * 1152 * 4
    assert round(kb.bound(flops, nbytes, kb.PEAK_F32_FLOPS)[0], 3) == 0.072
    # ResNet34's TSTP: T' = 25, D = 2560
    assert round(kb.bound(*kb.masked_stats(512, 25, 2560),
                          kb.PEAK_F32_FLOPS)[0], 3) == 0.023


def test_inv_bottleneck_stage_counts_by_hand():
    # Gemini_DF_ResNet114's stages at B=512 x 200 frames: per block two 1x1
    # products between C and 4C and a depthwise 3x3 at 4C; 4.8 TFLOP in
    # all, 5.07 ms at the bf16 peak, 3.79 of it stage 2
    stages = ((40, 200, 32, 3), (20, 100, 64, 3), (10, 100, 128, 27),
              (5, 100, 256, 3))
    total_ms = 0.0
    for f, t, c, depth in stages:
        flops, nbytes = kb.inv_bottleneck_stage(512, f, t, c, depth)
        p = 512 * f * t
        assert flops == depth * (4 * p * c * 4 * c + 2 * p * 9 * 4 * c)
        assert nbytes > 2 * p * c * 2  # x read and the output written once
        ms, by = kb.bound(flops, nbytes)
        assert by == "operations"
        total_ms += ms
    assert round(total_ms, 3) == 5.072
    assert round(kb.bound(*kb.inv_bottleneck_stage(512, 10, 100, 128, 27))[0],
                 3) == 3.793


def test_dw_pack_counts_by_hand():
    # ResNet34's three packed dW shapes at the recipe's B=128 x 200 frames:
    # one product of (3 Co, 3 Ci) over K = B*H*W rows, x and dy read once,
    # the f32 (Co, Ci, 3, 3) written once; each bound by bytes, about 0.078
    # ms for a layer1 conv
    shapes = {"stem": (80, 200, 1, 32), "layer1": (80, 200, 32, 32),
              "layer2": (40, 100, 64, 64)}
    for name, (h, w, ci, co) in shapes.items():
        flops, nbytes = kb.dw_pack(128, h, w, ci, co)
        k = 128 * h * w
        assert flops == 2 * k * 9 * ci * co
        assert nbytes == k * (ci + co) * 2 + 9 * ci * co * 4
        assert kb.bound(flops, nbytes)[1] == "bytes", name
    assert round(kb.bound(*kb.dw_pack(128, 80, 200, 32, 32))[0], 3) == 0.078


@pytest.mark.parametrize("name,shape,bytes_by_hand,want_ms", [
    # the stem reads x (1 channel) and dy (32): 128*80*200 positions
    ("stem", (80, 200, 1, 32), 2_048_000 * 33 * 2 + 288 * 4, 0.040),
    ("layer1", (80, 200, 32, 32), 2_048_000 * 64 * 2 + 9216 * 4, 0.078),
    # layer2 is 40 x 100 after the stride-2 conv: a quarter of the positions
    ("layer2", (40, 100, 64, 64), 512_000 * 128 * 2 + 36864 * 4, 0.039),
])
def test_dw_pack_bound_per_shape(name, shape, bytes_by_hand, want_ms):
    """The per-call bounds PERF.md's row 10 gives each ResNet34 shape at
    B=128: bytes over 3.35 TB/s, rounded to the microsecond."""
    flops, nbytes = kb.dw_pack(128, *shape)
    assert nbytes == bytes_by_hand
    ms, by = kb.bound(flops, nbytes)
    assert by == "bytes" and round(ms, 3) == want_ms


def test_mfa_astp_tail_bwd_floor_by_hand():
    # row 5's bf16 design at B=256, T=200, C=512 (M = 51,200 rows): the
    # logits' f32 write 0.098 ms; the softmax backward reads the f32
    # logits and h and writes dlogits and dh_pool once, 944 MB, 0.282; dpre
    # reads dlogits, 0.055; dacc reads dpre, h and dh_pool and writes dacc,
    # 0.192; dx and the three weight gradients by operations, 241.6 GFLOP
    # (0.244) and 281.8 (0.285); the sum of the splits' slabs 0.026: ~1.18
    m = 256 * 200
    steps = dict((n, (ms, by)) for n, ms, by in
                 kb.mfa_astp_tail_bwd_floor(256, 200, 512))
    assert steps["softmax_bwd"] == (pytest.approx(m * 1536 * 12 / 3.35e9),
                                    "bytes")
    assert round(m * 1536 * 12 / 1e6) == 944
    assert steps["dx_gemm"] == (pytest.approx(
        2 * m * 1536 * 1536 / 989e12 * 1e3), "operations")
    assert steps["weight_grads"][1] == "operations"
    assert round(steps["weight_grads"][0], 3) == 0.285
    # the split sum reads the slabs of the launch's own plan, 7 splits of
    # its 168 tiles at 800 K tiles, and writes the gradients once
    wgrad = 3 * 512 * 1536 + 2 * 128 * 1536
    assert g9.tn_splits(168, 800, sms=132) == (7, 115)
    assert steps["splitk_sum"] == (pytest.approx(8 * wgrad * 4 / 3.35e9),
                                   "bytes")
    assert round(steps["dacc_gemm"][0], 3) == 0.192
    assert round(steps["logits_gemm"][0], 3) == 0.098
    total = sum(ms for ms, _ in steps.values())
    assert round(total, 2) == 1.18
    assert kb.ROWS[-1][0] == 5 and round(kb.ROWS[-1][4][0], 2) == 1.18
