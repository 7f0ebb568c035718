"""A whole Gemini DF-ResNet stage (inference, BN folded) as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/inv_bottleneck_pallas.py
(`fused_inv_bottleneck_stage`, pallas_call at :167; `_stage_kernel`,
`_shift2d`, `_tap_roll`). Block i of L, on every position (f, t) of the
map x (B, F, T, C), computes

    h = relu((x @ w1[i]) * s1[i] + t1[i])                 1x1 to 4C
    g = relu(dw3x3(h; wdw[i]) * s2[i] + t2[i])            depthwise 3x3
    x = relu((g @ w2[i]) * s3[i] + t3[i] + x)             1x1 back to C

with zeros beyond the real ends of F and T (the convs' SAME padding), f32
accumulation, and x's type (bf16 or f32) wherever `_stage_kernel` rounds:
h, g and each block's output. Weights are rounded to x's type, as the TPU
kernel receives them.

Bound on an H100 at Gemini_DF_ResNet114's extraction shape (B=512 x 200
frames, feat 80; stage maps (F, T, C) = (40, 200, 32), (20, 100, 64),
(10, 100, 128), (5, 100, 256) with 3, 3, 27, 3 blocks): 4.8 TFLOP, 5.07
ms at 989 TFLOP/s, 3.79 of it stage 2 (`bin/kernel_bounds.py`): compute-
bound, almost all of it the two 1x1 products. The TPU kernel kept a batch
tile's whole stage in VMEM, with the 4x-expanded map h never leaving it;
one utterance's stage-0 h, (40, 200, 128) bf16, is 2 MB, nine times the
H100's 227 KB of shared memory. So the bf16 route tiles each block:

- one launch a block (L a call, 36 for Gemini_DF_ResNet114's four
  calls), one CTA an SM. A CTA owns an Fo x To tile of one utterance's
  (F, T) plane (`stage_plan`) and TMA loads its x tile with a
  one-position halo, (Fo + 2 fhalo) x (To + 2) x C (fhalo = 0 when
  Fo = F: rows beyond the map need no loading);
- for each chunk of 4C (64 channels; 32 at C = 32): the expand product on
  wgmma (x tile as K-major A, the w1 chunk as K-major B, TMA-fed), its
  BN1-relu epilogue rounded to bf16 and set to zero at every halo
  position outside the map into a shared-memory h chunk; the depthwise
  3x3 and BN2-relu on CUDA cores in f32 (tap sums T offset outer, BN2's
  scale folded into the taps: the same f32 sums in another order) into a
  g chunk in wgmma's swizzled K-major layout; the project product on
  wgmma, accumulated in registers over the chunks;
- then BN3, the residual (from the x tile in shared memory) and relu,
  rounded to bf16 and written once. h and g never reach device memory;
  blocks ping-pong between two (B, F, T, C) buffers, since a CTA's halo
  is its neighbours' tiles.
The CTA's four warpgroups take two roles, a chunk apart (warp
specialisation): two run the products and the expand epilogue (168
registers a thread: the project accumulator, 64 f32, lives there), two
the depthwise (88 registers), handing double-buffered h and g chunks
over through mbarriers, so that the tensor cores and the epilogue run
while the depthwise does; the weight chunks (w1 with its BN and taps,
packed by `_chunk_vectors`; w2) stream in by TMA. The tile per width
(`STAGE_CONFIGS`) is all of F by 10 frames at B=512 x 200 frames: the
M padding to 64-row multiples and the recomputed halo are the waste
(stage 2: 100 outputs in 128 rows, 120 halo positions in 128). What
holds it back on the H100 (PERF.md, row 9): the depthwise's CUDA-core
work (9 f32 FMAs an element of g, ~16 instructions an element) and the
shared-memory traffic of all four steps, not the tensor cores.

The f32 route keeps three launches a block (3 L a call) with h and g in
device memory: the expand GEMM on `common.cuh::gemm` with a BN1-relu
epilogue (CUDA-core FMA: TF32 misses 1e-4); the depthwise 3x3, BN2 and
relu, a thread owning 4 channels of one (b, f) row and walking T with a
3 x 3 window and the nine taps in registers; the project GEMM with a BN3 +
residual + relu epilogue writing the block's output in place.

The map is a logical (B, C, F, T) tensor in `torch.channels_last` memory
format, whose storage is exactly the JAX package's (B, F, T, C).
"""

import collections
import ctypes
import functools

import torch

from wespeaker_tpu_torch.ops import _build
from wespeaker_tpu_torch.ops.se_block import _dot


def _dw3x3(h: torch.Tensor, wdw: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 of h (B, F, T, D) with zero padding, f32, the taps
    summed in the order of JAX `_stage_kernel` (F offset outer, T offset
    inner). wdw: (3, 3, D)."""
    hp = torch.nn.functional.pad(h.float(), (0, 0, 1, 1, 1, 1))
    f, t = h.shape[1], h.shape[2]
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for df in range(3):
        for dt in range(3):
            y = y + hp[:, df:df + f, dt:dt + t] * wdw[df, dt].float()
    return y


def inv_bottleneck_stage_reference(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """Plain PyTorch Gemini stage with the contract of
    fused_inv_bottleneck_stage; rounds where JAX `_stage_kernel` rounds."""
    io = x.dtype
    xs = x.permute(0, 2, 3, 1)  # (B, F, T, C)
    for i in range(w1.shape[0]):
        h = _dot(xs, w1[i].to(io))
        h = torch.relu(h * s1[i].float() + t1[i].float()).to(io)
        y = _dw3x3(h, wdw[i].to(io))
        g = torch.relu(y * s2[i].float() + t2[i].float()).to(io)
        p = _dot(g, w2[i].to(io)) * s3[i].float() + t3[i].float()
        xs = torch.relu(p + xs.float()).to(io)
    return xs.permute(0, 3, 1, 2)  # channels-last: the storage of xs


def _check_args(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """The contract, on every device, in what a torch.export trace keeps
    static: x four-dimensional and the stacked per-block weights of its
    width C, at least one block."""
    if x.dim() != 4:
        raise ValueError(f"fused_inv_bottleneck_stage takes x as a "
                         f"channels-last (B, C, F, T) map; got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    num_blocks = w1.shape[0]
    want = {"w1": (w1, (num_blocks, c, 4 * c)),
            "s1": (s1, (num_blocks, 4 * c)), "t1": (t1, (num_blocks, 4 * c)),
            "wdw": (wdw, (num_blocks, 3, 3, 4 * c)),
            "s2": (s2, (num_blocks, 4 * c)), "t2": (t2, (num_blocks, 4 * c)),
            "w2": (w2, (num_blocks, 4 * c, c)),
            "s3": (s3, (num_blocks, c)), "t3": (t3, (num_blocks, c))}
    for name, (v, shape) in want.items():
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} {tuple(v.shape)} != {shape} for a "
                             f"stage of {num_blocks} blocks at width {c}")
    if num_blocks < 1:
        raise ValueError("empty stage: 0 blocks")


def _check_map(x):
    """The map's layout and size, checked where the op runs on real
    tensors: on an export's symbolic B and T these would specialise them
    (a dimension of 1 makes channels-last ambiguous)."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"fused_inv_bottleneck_stage takes x as a "
                         f"channels-last (B, C, F, T) map; got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    if x.numel() == 0:
        raise ValueError(f"empty stage input {tuple(x.shape)}")


# Per stage width, csrc/inv_bottleneck.cu's InvCfg: channels of 4C a
# chunk, the halo and output M-blocks (64 positions) of a tile, and the w1
# slots
StageConfig = collections.namedtuple("StageConfig", "chunk me mo w1_slots")
STAGE_CONFIGS = {32: StageConfig(32, 8, 8, 3), 64: StageConfig(64, 4, 4, 3),
                 128: StageConfig(64, 2, 2, 3), 256: StageConfig(64, 2, 1, 2)}
SMEM_LIMIT = 232448   # the H100's shared memory a block can use
TMA_BOX = 256         # a TMA box's largest extent along a dimension

# fo x to outputs a tile, fhalo 1 where the tile carries F halo rows
# (fo < F), the 4C chunk width and the kernel's shared-memory bytes
StagePlan = collections.namedtuple("StagePlan", "fo to fhalo chunk smem")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def stage_smem(c: int, halo: int, th: int) -> int:
    """Shared-memory bytes of the bf16 kernel at width c for a halo tile of
    `halo` positions, `th` of them along T (csrc/inv_bottleneck.cu's
    inv_smem): the x tile in 1 KB-aligned slabs of min(C, 64) channels,
    the w1 slots (a chunk with its BN and taps), two w2 slots, two g chunks
    (the project's M-blocks), two h chunks (planes of 8 channels, each the
    halo and a zero row of th positions, an odd number of 16 bytes apart),
    s3 and t3, the mbarriers and 1 KB of alignment slack."""
    cfg = STAGE_CONFIGS[c]
    s = min(c, 64)
    nc = cfg.chunk
    x = (c // s) * _round_up(halo * 2 * s, 1024)
    w1 = cfg.w1_slots * _round_up(nc * 2 * c + 34 * nc, 1024)
    w2 = 2 * c * 2 * nc
    g = 2 * cfg.mo * 64 * 2 * nc
    h = 2 * nc // 8 * ((halo + th) // 2 * 2 + 1) * 16
    bn3 = 2 * c * 4
    return x + w1 + w2 + g + h + bn3 + (9 + cfg.w1_slots) * 8 + 1024


def stage_plan(f: int, t: int, c: int, max_out=None,
               max_halo=None) -> StagePlan:
    """The bf16 kernel's tile for a (F, T) map at width c: the one that
    computes the fewest halo positions (the expand and its epilogue run on
    every one), then the fewest tiles, among those whose outputs fit the
    project's M-blocks (fo * to <= max_out, default 64 mo) and whose halo
    fits the expand's ((fo + 2 fhalo) * (to + 2) <= max_halo, default
    64 me), each extent of the x box at most 256 and the shared memory at
    most SMEM_LIMIT; fhalo = 1 where fo < F. To is evened out over its
    tile count. max_out and max_halo below the defaults plan smaller tiles
    (the tests' tile-by-tile emulation)."""
    if c not in STAGE_CONFIGS:
        raise ValueError(f"the bf16 stage kernel takes C in "
                         f"{sorted(STAGE_CONFIGS)}, not {c}")
    if f < 1 or t < 1:
        raise ValueError(f"empty map ({f}, {t})")
    cfg = STAGE_CONFIGS[c]
    max_out = max_out or 64 * cfg.mo
    max_halo = max_halo or 64 * cfg.me
    best = None
    for fo in range(f, 0, -1):
        fhalo = 0 if fo == f else 1
        fh = fo + 2 * fhalo
        top = min(t, max_out // fo, max_halo // fh - 2, TMA_BOX - 2)
        if fh > TMA_BOX:
            continue
        for nt in sorted({-(-t // to) for to in range(1, top + 1)}):
            to = -(-t // nt)
            tiles = -(-f // fo) * nt
            smem = stage_smem(c, fh * (to + 2), to + 2)
            cost = (tiles * fh * (to + 2), tiles)  # halo positions, tiles
            if smem <= SMEM_LIMIT and (best is None or cost < best[0]):
                best = (cost, StagePlan(fo, to, fhalo, cfg.chunk, smem))
    if best is None:
        raise ValueError(f"no tile of the bf16 stage kernel fits F={f}, "
                         f"T={t} at C={c}")
    return best[1]


def _chunk_vectors(s1, t1, s2, t2, wdw, chunk):
    """The bf16 kernel's per-chunk vectors, (L, 4C / chunk, 34 chunk)
    bytes: for each chunk of 4C, s1, t1, s2 and t2 (chunk f32 each), then
    the 9 x chunk bf16 taps; one bulk copy a chunk."""
    num_blocks, c4 = s1.shape
    n = c4 // chunk
    bn = torch.stack([s1, t1, s2, t2], 1).to(device=wdw.device,
                                             dtype=torch.float32)
    bn = bn.reshape(num_blocks, 4, n, chunk).transpose(1, 2).contiguous()
    taps = wdw.reshape(num_blocks, 9, n, chunk).transpose(1, 2).contiguous()
    return torch.cat([bn.view(torch.uint8).reshape(num_blocks, n, -1),
                      taps.view(torch.uint8).reshape(num_blocks, n, -1)],
                     dim=2).contiguous()


def _check_cuda_args(x):
    b, c, f, t = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_inv_bottleneck_stage takes f32 or bf16, not "
                        f"{x.dtype}")
    if c % 32:
        raise ValueError(f"the stage width {c} must be a multiple of 32")
    if b * f * t >= 2 ** 31:
        raise ValueError(f"B*F*T = {b * f * t} positions do not fit the "
                         "kernel's 32-bit row count")


def fused_inv_bottleneck_stage(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """x: (B, C, F, T) in channels-last memory format. Stacked per-block
    weights, BN folded:
      w1 (L, C, 4C)        1x1 expand (in, out), no bias
      s1/t1 (L, 4C)        folded bn1 scale/shift
      wdw (L, 3, 3, 4C)    depthwise taps [f offset, t offset, channel]
      s2/t2 (L, 4C)        folded bn2
      w2 (L, 4C, C)        1x1 project (in, out), no bias
      s3/t3 (L, C)         folded bn3
    Returns the stage output, (B, C, F, T) channels-last in x's dtype (a
    view of a contiguous (B, F, T, C) buffer).

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_inv_bottleneck_stage`, so a torch.export program holds it as one
    node: its CPU implementation is the plain version, its CUDA one the
    kernel (bf16: one launch a block; f32: three), or raises for a shape,
    layout or type it does not take. The op has no autograd formula, so on
    the CPU with gradients wanted the plain version runs directly."""
    args = (x, w1, s1, t1, wdw, s2, t2, w2, s3, t3)
    _check_args(*args)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_inv_bottleneck_stage: no kernel for "
                         f"{x.device}")
    if (x.device.type == "cpu" and torch.is_grad_enabled()
            and any(v.requires_grad for v in args)):
        _check_map(x)
        return inv_bottleneck_stage_reference(*args)
    return torch.ops.wespeaker_tpu_torch.fused_inv_bottleneck_stage(*args)


fused_inv_bottleneck_stage.launches = 0

_T = torch.Tensor


@torch.library.custom_op("wespeaker_tpu_torch::fused_inv_bottleneck_stage",
                         mutates_args=(), device_types="cpu")
def _stage_op(x: _T, w1: _T, s1: _T, t1: _T, wdw: _T, s2: _T, t2: _T,
              w2: _T, s3: _T, t3: _T) -> _T:
    _check_map(x)
    return inv_bottleneck_stage_reference(x, w1, s1, t1, wdw, s2, t2, w2,
                                          s3, t3)


@_stage_op.register_fake
def _stage_op_fake(x, *rest):
    b, c, f, t = x.shape
    return x.new_empty((b, f, t, c)).permute(0, 3, 1, 2)


@_stage_op.register_kernel("cuda")
@_build.on_device
def _stage_op_cuda(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    _check_map(x)
    _check_cuda_args(x)
    b, c, f, t = x.shape
    num_blocks = w1.shape[0]
    io = x.dtype
    dev = x.device
    plan = stage_plan(f, t, c) if io == torch.bfloat16 else None

    def io_(v):
        return v.to(device=dev, dtype=io).contiguous()

    def f32(v):
        return v.to(device=dev, dtype=torch.float32).contiguous()

    xs = x.permute(0, 2, 3, 1)  # contiguous (B, F, T, C): the same storage
    out = xs.new_empty((b, f, t, c))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan is not None:
        # K-major operands: w1 as (L, 4C, C), w2 as (L, C, 4C); and each
        # chunk's vectors packed as the kernel loads them
        tmp = torch.empty_like(out) if num_blocks > 1 else None
        ops = [xs, io_(w1.transpose(1, 2)), io_(w2.transpose(1, 2)),
               _chunk_vectors(s1, t1, s2, t2, io_(wdw), plan.chunk),
               f32(s3), f32(t3), out]
        ptr = _build.pointers(ops) + [tmp.data_ptr() if tmp is not None
                                      else None]
        rc = lib.ws_inv_stage_bf16(*ptr, b, f, t, c, num_blocks, plan.fo,
                                   plan.to, plan.fhalo, plan.smem, stream)
    else:
        h = torch.empty((b, f, t, 4 * c), device=dev, dtype=io)
        g = torch.empty_like(h)
        ptr = _build.pointers([xs, io_(w1), f32(s1), f32(t1), io_(wdw),
                               f32(s2), f32(t2), io_(w2), f32(s3), f32(t3),
                               h, g, out])
        rc = lib.ws_inv_bottleneck_stage(*ptr, b, f, t, c, num_blocks,
                                         stream)
    _build.check(lib, rc, "fused_inv_bottleneck_stage")
    fused_inv_bottleneck_stage.launches += 1
    return out.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("inv_bottleneck")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_inv_stage_bf16.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.ws_inv_stage_bf16.restype = i
    lib.ws_inv_bottleneck_stage.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.ws_inv_bottleneck_stage.restype = i
    return lib
