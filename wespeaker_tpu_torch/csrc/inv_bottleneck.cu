// A whole Gemini DF-ResNet stage for inference, BN folded (see
// wespeaker_tpu_torch/ops/inv_bottleneck.py for the math, the bound, the
// tile plan and the design). Replaces the Pallas kernel
// wespeaker_tpu/ops/inv_bottleneck_pallas.py::fused_inv_bottleneck_stage.
//
// C interface:
//   ws_inv_stage_bf16(...): bf16, one launch of inv_block_kernel a block of
//     the stage, on the given stream. A CTA owns an Fo x To tile of one
//     utterance's (F, T) plane and keeps h and g in shared memory: TMA
//     loads its x tile with a one-position halo; for each chunk of 4C the
//     expand product (wgmma) and its BN1-relu epilogue write an h chunk and
//     the depthwise 3x3 and BN2-relu (CUDA cores, f32) a g chunk; then the
//     project product (wgmma, K = 4C), BN3, the residual (from the x tile)
//     and relu. Blocks ping-pong between `out` and `tmp`, since a CTA's
//     halo is its neighbours' tiles; the last block writes `out`.
//   ws_inv_bottleneck_stage(...): f32, three launches a block:
//     expand GEMM (BN1-relu epilogue)                  x -> h (M, 4C)
//     -> depthwise 3x3, BN2, relu                      h -> g (M, 4C)
//     -> project GEMM (BN3 + residual + relu epilogue) g -> out (M, C)
//     with M = B*F*T channels-last positions; block 0 reads x, later
//     blocks read and overwrite out (CUDA-core FMA: TF32 misses 1e-4).
// Both return the first CUDA error (0 on success).

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace ws {

// ---- bf16: one kernel a block, h and g in shared memory ----
//
// One CTA an SM, four warpgroups in two roles that run about a chunk of 4C
// apart:
// - E (warpgroups 0-1, kInvRegsE registers a thread): for chunk j, the
//   expand products (wgmma) and their BN1-relu epilogue into h[j % 2],
//   then chunk j - 1's project products (wgmma, asynchronous: they run
//   during chunk j + 1's expand) into the accumulator; at the end BN3, the
//   residual and relu;
// - D (warpgroups 2-3, kInvRegsD registers): the depthwise 3x3 of chunk j
//   from h[j % 2] into g[j % 2] (CUDA cores, f32),
// handing h and g over through mbarriers (h_full, h_empty, g_full), so
// that the tensor cores and the epilogue run while the depthwise does.
// Thread 0 issues the copies (TMA): the x tile, then the w1 chunks (each
// with its BN1, BN2 and taps) through kW1 slots and the w2 chunks through
// two, each refilled once E knows its last reader is done.
//
// Per stage width, mirrored by ops/inv_bottleneck.py's STAGE_CONFIGS (the
// planner that picks the tile): kNC channels of 4C a chunk; kME halo
// M-blocks (64 positions), half for each E warpgroup; kMO output
// M-blocks; kW1 w1 slots. An E warpgroup holds the project accumulator of
// max(kMO / 2, 1) M-blocks by C (kMO >= 2) or C / 2 (kMO = 1) columns:
// 64 f32 a thread at every width. At B=512 x 200 frames the tiles are all
// of F by 10 frames.
template <int kC>
struct InvCfg;
template <>
struct InvCfg<32> {
  static constexpr int kNC = 32, kME = 8, kMO = 8, kW1 = 3;
};
template <>
struct InvCfg<64> {
  static constexpr int kNC = 64, kME = 4, kMO = 4, kW1 = 3;
};
template <>
struct InvCfg<128> {
  static constexpr int kNC = 64, kME = 2, kMO = 2, kW1 = 3;
};
template <>
struct InvCfg<256> {
  static constexpr int kNC = 64, kME = 2, kMO = 1, kW1 = 2;
};
constexpr int kInvThreads = 512;  // four warpgroups
constexpr int kInvE = 256, kInvD = 256;  // threads of E, of D
constexpr int kInvRegsE = 168, kInvRegsD = 88;

// Shared-memory layout (byte offsets from a 1 KB-aligned base), the same
// formula as ops/inv_bottleneck.py's stage_smem: the x tile as C / S slabs
// of S channels (S = min(C, 64), one S * 2-byte swizzled row a halo
// position, each slab 1 KB-aligned); kW1 w1 slots, each a w1 chunk (kNC
// rows of C, as slabs) and its vectors (kNC f32 each of s1, t1, s2, t2,
// then the 9 x kNC bf16 taps); two w2 slots (C rows of kNC); two g chunks
// (kMO * 64 rows of kNC); two h chunks (below); s3 and t3 (C f32 each);
// 9 + kW1 mbarriers; and 1 KB of slack to align the base.
//
// h is the threads' own: kNC / 8 planes of 8 channels, each 16 bytes a
// halo position and, after the halo, one row of To + 2 zeros that the
// depthwise reads for rows beyond the tile; planes an odd number of 16
// bytes apart (h_plane). The expand epilogue's stores (8 positions x 16
// bytes a warp) and the depthwise's loads (8 planes x 16 bytes of one
// position a warp) then hit 32 different banks, and a position's
// neighbours in T are 16 bytes apart.
struct InvSmem {
  int x_slab, w1, w1_chunk, w_vec, w1_slot, w2, w2_slot, g, g_chunk, h,
      h_plane, h_chunk, bn3, bars, total;
};

__host__ __device__ inline InvSmem inv_smem(int c, int nc, int mo_blocks,
                                            int w1_slots, int halo, int th) {
  const int s = c < 64 ? c : 64;
  InvSmem l;
  l.x_slab = round_up(halo * 2 * s, 1024);
  l.w1 = (c / s) * l.x_slab;
  l.w1_chunk = nc * 2 * c;
  l.w_vec = 4 * nc * 4 + 9 * nc * 2;
  l.w1_slot = round_up(l.w1_chunk + l.w_vec, 1024);
  l.w2 = l.w1 + w1_slots * l.w1_slot;
  l.w2_slot = c * 2 * nc;
  l.g = l.w2 + 2 * l.w2_slot;
  l.g_chunk = mo_blocks * 64 * 2 * nc;
  l.h = l.g + 2 * l.g_chunk;
  l.h_plane = ((halo + th) / 2 * 2 + 1) * 16;
  l.h_chunk = nc / 8 * l.h_plane;
  l.bn3 = l.h + 2 * l.h_chunk;
  l.bars = l.bn3 + 2 * c * 4;
  l.total = l.bars + (9 + w1_slots) * 8 + 1024;
  return l;
}

// the barrier of E's 256 threads (id 1; 0 is __syncthreads)
__device__ __forceinline__ void e_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kInvE) : "memory");
}

struct InvArgs {
  __nv_bfloat16* out;         // (b, f, t, c): this block's output
  // this block's chunk vectors: for each chunk of kNC channels of 4C, s1,
  // t1, s2, t2 (kNC f32 each) then its taps (9 x kNC bf16), packed
  const unsigned char* vecs;
  const float *s3, *t3;  // this block's folded BN3
  int b, f, t;
  int fo, to, fhalo;  // output tile; 1 if it carries F halo rows (Fo < F)
  int nf, nt;         // tiles along F and T
  int blk;            // the block's index in the stacked weight maps
};

template <int kC>
__global__ void __launch_bounds__(kInvThreads, 1)
    inv_block_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w1,
                     const __grid_constant__ CUtensorMap tm_w2,
                     const InvArgs a) {
  using Cfg = InvCfg<kC>;
  constexpr int kNC = Cfg::kNC, kME = Cfg::kME, kMO = Cfg::kMO;
  constexpr int kW1 = Cfg::kW1;
  constexpr int kS = kC < 64 ? kC : 64;  // channels a slab of x and w1
  constexpr int kRB = 2 * kS;            // bytes a row of x and w1
  constexpr int kSlabs = kC / kS;
  constexpr int kGB = 2 * kNC;  // bytes a row of h, g and w2
  constexpr int kChunks = 4 * kC / kNC;
  constexpr int kMEW = kME / 2;                 // halo M-blocks an E group
  constexpr int kPME = kMO >= 2 ? kMO / 2 : 1;  // project M-blocks, and
  constexpr int kNWE = kMO >= 2 ? kC : kC / 2;  // columns, an E group
  static_assert(kME % 2 == 0, "halo M-blocks split evenly");
  constexpr uint32_t kLayX = kRB == 128 ? 1u : 2u;  // 128- or 64-byte
  constexpr uint32_t kLayG = kGB == 128 ? 1u : 2u;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;
  // the warpgroup index, shuffled so the compiler knows it is warp-uniform:
  // a branch it cannot prove uniform makes it serialise the wgmmas
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wiw = (tid % 128) / 32, lane = tid % 32;
  const int fh = a.fo + 2 * a.fhalo, th = a.to + 2, halo = fh * th;
  const int outs = a.fo * a.to;
  const InvSmem l = inv_smem(kC, kNC, kMO, kW1, halo, th);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t x_s = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  // mbarriers, [2] by chunk parity: x; w2_full[2] (TMA); h_full[2] (E's 8
  // warps); h_empty[2] and g_full[2] (D's 8 warps); w1_full[kW1] (TMA)
  const uint32_t bar_x = x_s + l.bars, bar_w2 = bar_x + 8,
                 bar_hf = bar_x + 24, bar_he = bar_x + 40,
                 bar_gf = bar_x + 56, bar_w1 = bar_x + 72;
  // the same memory through plain C++ pointers, for the threads' own loads
  // and stores of h, g, x and the chunk vectors
  unsigned char* const sm = smem_raw + (x_s - raw);
  auto word = [&](int off) -> uint32_t& {
    return *reinterpret_cast<uint32_t*>(sm + off);
  };
  auto pair_at = [&](int off) -> float2 {
    return *reinterpret_cast<const float2*>(sm + off);
  };

  int idx = blockIdx.x;
  const int tt = idx % a.nt;
  idx /= a.nt;
  const int tf = idx % a.nf, bi = idx / a.nf;
  const int f0 = tf * a.fo, t0 = tt * a.to;
  const int fx = f0 - a.fhalo, tx = t0 - 1;  // the halo tile's origin

  if (tid == 0) {
    mbar_init(bar_x, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_w2 + 8 * i, 1);
      mbar_init(bar_hf + 8 * i, kInvE / 32);
      mbar_init(bar_he + 8 * i, kInvD / 32);
      mbar_init(bar_gf + 8 * i, kInvD / 32);
    }
    for (int i = 0; i < kW1; ++i) mbar_init(bar_w1 + 8 * i, 1);
    fence_mbar_init();
  }
  // the zero row after each h plane's halo
  for (int i = tid; i < 2 * (kNC / 8) * th; i += kInvThreads) {
    const int plane = i / th, k = i % th;
    *reinterpret_cast<uint4*>(sm + l.h + plane * l.h_plane +
                              (halo + k) * 16) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // copies, issued by thread 0: w1 chunk j with its vectors into slot
  // j % kW1, w2 chunk j into slot j % 2
  const bool lead = tid == 0;
  auto load_w1 = [&](int j) {
    if (j >= kChunks) return;
    const uint32_t dst = x_s + l.w1 + (j % kW1) * l.w1_slot,
                   full = bar_w1 + 8 * (j % kW1);
    mbar_expect_tx(full, l.w1_chunk + l.w_vec);
    for (int k = 0; k < kSlabs; ++k)
      tma_load_4d(dst + k * kNC * kRB, &tm_w1, k * kS, j * kNC, a.blk, 0,
                  full);
    bulk_load(dst + l.w1_chunk, a.vecs + (size_t)j * l.w_vec, l.w_vec, full);
  };
  auto load_w2 = [&](int j) {
    if (j >= kChunks) return;
    const uint32_t full = bar_w2 + 8 * (j & 1);
    mbar_expect_tx(full, l.w2_slot);
    tma_load_4d(x_s + l.w2 + (j & 1) * l.w2_slot, &tm_w2, j * kNC, 0, a.blk,
                0, full);
  };
  if (lead) {
    mbar_expect_tx(bar_x, kSlabs * halo * kRB + 2 * kC * 4);
    for (int s = 0; s < kSlabs; ++s)
      tma_load_4d(x_s + s * l.x_slab, &tm_x, s * kS, tx, fx, bi, bar_x);
    bulk_load(x_s + l.bn3, a.s3, kC * 4, bar_x);
    bulk_load(x_s + l.bn3 + kC * 4, a.t3, kC * 4, bar_x);
    for (int j = 0; j < kW1; ++j) load_w1(j);
    load_w2(0);
    load_w2(1);
  }

  if (wg < 2) {
    // ---- E: expand, its epilogue, the project ----
    setmaxnreg_inc<kInvRegsE>();
    const int e = wg;
    const int mb0 = kMO >= 2 ? e * kPME : 0, n0 = kMO >= 2 ? 0 : e * kNWE;
    float accp[kPME][kNWE / 2];
    // issues chunk j's products once D has written its g, and refills
    // chunk j's w1 slot, whose last reader (D's taps) is then done
    auto project = [&](int j) {
      mbar_wait(bar_gf + 8 * (j & 1), (j >> 1) & 1);
      if (lead) load_w1(j + kW1);
      mbar_wait(bar_w2 + 8 * (j & 1), (j >> 1) & 1);
      const uint32_t g_s = x_s + l.g + (j & 1) * l.g_chunk;
      const uint32_t w2_s = x_s + l.w2 + (j & 1) * l.w2_slot;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kPME; ++k) {
#pragma unroll
        for (int ks = 0; ks < kNC / 16; ++ks) {
          const uint64_t da = wgmma_desc(g_s + (mb0 + k) * 64 * kGB + ks * 32,
                                         16, 8 * kGB, kLayG);
          const uint64_t db = wgmma_desc(w2_s + n0 * kGB + ks * 32, 16,
                                         8 * kGB, kLayG);
          wgmma_m64k16_kk(accp[k], da, db, j > 0 || ks > 0);
        }
      }
      wgmma_commit();
    };
    // the epilogue's rows: each one's byte offset in an h plane (-1 past
    // the halo) and 1 inside the map, 0 outside (the same every chunk)
    int hp[kMEW][2];
    float live[kMEW][2];
#pragma unroll
    for (int k = 0; k < kMEW; ++k)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (e + 2 * k) * 64 + wiw * 16 + lane / 4 + 8 * hh;
        const int fr = p / th, tc = p - fr * th;
        const int ff = fx + fr, tq = tx + tc;
        hp[k][hh] = p < halo ? p * 16 + 4 * (lane % 4) : -1;
        live[k][hh] =
            ff >= 0 && ff < a.f && tq >= 0 && tq < a.t ? 1.f : 0.f;
      }
    mbar_wait(bar_x, 0);
#pragma unroll 1
    for (int j = 0; j < kChunks; ++j) {
      const uint32_t w1_s = x_s + l.w1 + (j % kW1) * l.w1_slot;
      const int vec = l.w1 + (j % kW1) * l.w1_slot + l.w1_chunk;
      const int hbase = l.h + (j & 1) * l.h_chunk;
      mbar_wait(bar_w1 + 8 * (j % kW1), (j / kW1) & 1);
      // BN1 for this thread's columns, read while the products run
      float2 s1v[kNC / 8], t1v[kNC / 8];
#pragma unroll
      for (int jj = 0; jj < kNC / 8; ++jj) {
        const int n = 8 * jj + 2 * (lane % 4);
        s1v[jj] = pair_at(vec + n * 4);
        t1v[jj] = pair_at(vec + kNC * 4 + n * 4);
      }
      if (j >= 2) mbar_wait(bar_he + 8 * (j & 1), ((j - 2) >> 1) & 1);
      // 1. expand: h = relu((x @ w1) * s1 + t1), zero outside the map
      // (the depthwise's SAME padding is on h; TMA's zero fill gives x = 0
      // there, which BN1 would turn into relu(t1)); rows past the halo
      // only pad the M-block and are dropped
#pragma unroll
      for (int k = 0; k < kMEW; ++k) {
        const int mb = e + 2 * k;
        float acce[kNC / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          const int slab = ks * 16 / kS, within = (ks * 16 % kS) * 2;
          const uint64_t da = wgmma_desc(
              x_s + slab * l.x_slab + mb * 64 * kRB + within, 16, 8 * kRB,
              kLayX);
          const uint64_t db = wgmma_desc(w1_s + slab * kNC * kRB + within, 16,
                                         8 * kRB, kLayX);
          wgmma_m64k16_kk(acce, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();  // also retires chunk j - 2's products
#pragma unroll
        for (int i = 0; i < kPME; ++i) fence_regs(accp[i]);
        fence_regs(acce);
        if (k == 0) {
          // g[j % 2] and w2 slot j % 2 are free in both E groups: refill
          // the slot
          e_sync();
          if (lead && j >= 2) load_w2(j);
        }
#pragma unroll
        for (int jj = 0; jj < kNC / 8; ++jj) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v0 = fmaxf(acce[4 * jj + 2 * hh] * s1v[jj].x +
                                       t1v[jj].x, 0.f) * live[k][hh];
            const float v1 = fmaxf(acce[4 * jj + 2 * hh + 1] * s1v[jj].y +
                                       t1v[jj].y, 0.f) * live[k][hh];
            if (hp[k][hh] >= 0)
              word(hbase + hp[k][hh] + jj * l.h_plane) = pack2(v0, v1);
          }
        }
      }
      __syncwarp();
      mbar_arrive_if(bar_hf + 8 * (j & 1), lane == 0);  // h[j % 2] whole
      // chunk j - 1's products: they run while the next chunk's expand
      // and epilogue do
      if (j > 0) project(j - 1);
    }
    project(kChunks - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kPME; ++i) fence_regs(accp[i]);

    // out = relu(acc * s3 + t3 + x), x from the tile in shared memory
#pragma unroll
    for (int k = 0; k < kPME; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = (mb0 + k) * 64 + wiw * 16 + lane / 4 + 8 * hh;
        const int fo_ = q / a.to, to_ = q - fo_ * a.to;
        const int ff = f0 + fo_, tq = t0 + to_;
        if (q >= outs || ff >= a.f || tq >= a.t) continue;
        const int p = (fo_ + a.fhalo) * th + to_ + 1;  // in the halo tile
        __nv_bfloat16* orow =
            a.out + (((size_t)bi * a.f + ff) * a.t + tq) * kC + n0;
#pragma unroll
        for (int jj = 0; jj < kNWE / 8; ++jj) {
          const int n = n0 + 8 * jj + 2 * (lane % 4);
          const float2 sc = pair_at(l.bn3 + n * 4);
          const float2 sh = pair_at(l.bn3 + kC * 4 + n * 4);
          float r0, r1;
          unpack2(
              word((n / kS) * l.x_slab + swz<kRB>(p * kRB + (n % kS) * 2)),
              r0, r1);
          const float v0 =
              fmaxf(accp[k][4 * jj + 2 * hh] * sc.x + sh.x + r0, 0.f);
          const float v1 =
              fmaxf(accp[k][4 * jj + 2 * hh + 1] * sc.y + sh.y + r1, 0.f);
          *reinterpret_cast<uint32_t*>(orow + n - n0) = pack2(v0, v1);
        }
      }
    }
  } else {
    // ---- D: the depthwise 3x3 from h in f32, g = relu(y * s2 + t2) into
    // g[j % 2], in the K-major swizzled layout the project reads as A. A
    // thread owns four channels (8-byte loads and stores) and walks one
    // span of the tile's outputs, row-major over (fo, to); each column of
    // h it loads (rows f-1, f, f+1) completes output t (its dt = 2 taps),
    // adds to t + 1 (dt = 1) and starts t + 2 (dt = 0), so each tap sum
    // runs T offset outer, F offset inner. BN2's scale is folded into the
    // taps and its shift starts each sum. Rows beyond the tile (fhalo = 0:
    // F's zero padding) read the zero row.
    setmaxnreg_dec<kInvRegsD>();
    constexpr int kQuads = kNC / 4;  // threads a position
    constexpr int kWalkers = kInvD / kQuads;
    const int dtid = tid - kInvE;
    const int quad = dtid % kQuads, walker = dtid / kQuads;
    const int span = (outs + kWalkers - 1) / kWalkers;
    const int q0 = walker * span, q1 = min(q0 + span, outs);
    const int zero_row = halo * 16;  // byte offset of the zero row
    auto quad_at = [&](int off) -> uint2 {
      return *reinterpret_cast<const uint2*>(sm + off);
    };
    auto unpack4 = [&](uint2 v, float (&o)[4]) {
      unpack2(v.x, o[0], o[1]);
      unpack2(v.y, o[2], o[3]);
    };
#pragma unroll 1
    for (int j = 0; j < kChunks; ++j) {
      const int vec = l.w1 + (j % kW1) * l.w1_slot + l.w1_chunk;
      const int hb = l.h + (j & 1) * l.h_chunk + (quad / 2) * l.h_plane +
                     8 * (quad % 2);
      const int gb = l.g + (j & 1) * l.g_chunk;
      mbar_wait(bar_hf + 8 * (j & 1), (j >> 1) & 1);
      float w[3][3][4];  // [f offset][t offset][channel], times s2
      float sh[4];       // t2
      {
        const float4 sc4 =
            *reinterpret_cast<const float4*>(sm + vec + 2 * kNC * 4 + quad * 16);
        const float4 sh4 =
            *reinterpret_cast<const float4*>(sm + vec + 3 * kNC * 4 + quad * 16);
        const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
        sh[0] = sh4.x, sh[1] = sh4.y, sh[2] = sh4.z, sh[3] = sh4.w;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          unpack4(quad_at(vec + 16 * kNC + k * kNC * 2 + quad * 8),
                  w[k / 3][k % 3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) w[k / 3][k % 3][c] *= sc[c];
        }
      }
      int hr[3];               // each row's byte offset at the next column
      float y0[4], y1[4];      // outputs t and t + 1, partly summed
      auto column = [&](float (&v)[3][4]) {
#pragma unroll
        for (int df = 0; df < 3; ++df) {
          unpack4(quad_at(hr[df]), v[df]);
          hr[df] += 16;
        }
      };
      // adds a column with the taps of t offset dt to y
      auto add = [&](float (&y)[4], const float (&v)[3][4], int dt) {
#pragma unroll
        for (int df = 0; df < 3; ++df)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            y[c] = fmaf(v[df][c], w[df][dt][c], y[c]);
      };
      int fo_ = q0 / a.to, to_ = q0 - fo_ * a.to;
      for (int q = q0; q < q1; ++q) {
        float v[3][4];
        if (q == q0 || to_ == 0) {  // a new row: its first two columns
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const int r = fo_ + df - 1 + a.fhalo;
            hr[df] = hb + (r >= 0 && r < fh ? (r * th + to_) * 16
                                            : zero_row + to_ * 16);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) y0[c] = y1[c] = sh[c];
          column(v);
          add(y0, v, 0);
          column(v);
          add(y0, v, 1);
          add(y1, v, 0);
        }
        column(v);
        add(y0, v, 2);
        add(y1, v, 1);
        *reinterpret_cast<uint2*>(sm + gb + swz<kGB>(q * kGB + quad * 8)) =
            make_uint2(pack2(fmaxf(y0[0], 0.f), fmaxf(y0[1], 0.f)),
                       pack2(fmaxf(y0[2], 0.f), fmaxf(y0[3], 0.f)));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y0[c] = y1[c];
          y1[c] = sh[c];
        }
        add(y1, v, 0);
        if (++to_ == a.to) {
          to_ = 0;
          ++fo_;
        }
      }
      fence_proxy_async();  // g's writes, before the wgmmas read it
      __syncwarp();
      mbar_arrive_if(bar_gf + 8 * (j & 1), lane == 0);  // g[j % 2] whole
      mbar_arrive_if(bar_he + 8 * (j & 1), lane == 0);  // h[j % 2] read
    }
  }
}

template <int kC>
cudaError_t inv_stage_bf16(const void* x, const void* w1t, const void* w2t,
                           const unsigned char* vecs, const float* s3,
                           const float* t3, __nv_bfloat16* out,
                           __nv_bfloat16* tmp, int b, int f, int t,
                           int blocks, int fo, int to, int fhalo, int smem,
                           cudaStream_t stream) {
  using Cfg = InvCfg<kC>;
  constexpr int kS = kC < 64 ? kC : 64;
  const int fh = fo + 2 * fhalo, th = to + 2;
  // the plan (ops/inv_bottleneck.py::stage_plan) must fit this width's
  // tile: outputs in the project's M-blocks, the halo in the expand's, a
  // TMA box of at most 256 a dimension, and the same shared memory
  const InvSmem l = inv_smem(kC, Cfg::kNC, Cfg::kMO, Cfg::kW1, fh * th, th);
  if (fo < 1 || to < 1 || (fhalo != 0 && fhalo != 1) || (!fhalo && fo != f) ||
      fo > f || fo * to > 64 * Cfg::kMO || fh * th > 64 * Cfg::kME ||
      fh > 256 || th > 256 || l.total != smem || smem > 232448 ||
      (blocks > 1 && tmp == nullptr))
    return cudaErrorInvalidValue;
  const int nf = (f + fo - 1) / fo, nt = (t + to - 1) / to;
  const long long tiles = (long long)b * nf * nt;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;

  // maps: the stage input and the two ping-pong buffers (B, F, T, C) with
  // the halo tile's box; w1t (L, 4C, C) in (kNC, S) boxes; w2t (L, C, 4C)
  // in (C, kNC) boxes
  CUtensorMap tm_src[3], tm_w1, tm_w2;
  const void* bufs[3] = {x, out, tmp};
  for (int i = 0; i < 3; ++i)
    if (bufs[i] != nullptr &&
        !tensor_map_4d_bf16(&tm_src[i], bufs[i], kC, t, f, b, kS, th,
                            2 * kS, fh))
      return cudaErrorInvalidValue;
  if (!tensor_map_4d_bf16(&tm_w1, w1t, kC, 4 * kC, blocks, 1, kS, Cfg::kNC,
                          2 * kS) ||
      !tensor_map_4d_bf16(&tm_w2, w2t, 4 * kC, kC, blocks, 1, Cfg::kNC, kC,
                          2 * Cfg::kNC))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inv_block_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int src = 0;  // block 0 reads x
  for (int i = 0; i < blocks; ++i) {
    // the last block writes out; the others alternate so that no block
    // writes the buffer it reads
    const int dst = (blocks - 1 - i) % 2 == 0 ? 1 : 2;
    const InvArgs args{dst == 1 ? out : tmp,
                       vecs + (size_t)i * (4 * kC / Cfg::kNC) * l.w_vec,
                       s3 + (size_t)i * kC, t3 + (size_t)i * kC,
                       b, f, t, fo, to, fhalo, nf, nt, i};
    inv_block_kernel<kC><<<(unsigned)tiles, kInvThreads, smem, stream>>>(
        tm_src[src], tm_w1, tm_w2, args);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// ---- f32: the depthwise 3x3 on channels-last rows ----
//
// A thread owns 4 channels of one row r = b * F + f of the map and walks
// the frames of its t chunk. It keeps their nine taps and a 3 x 3 window of
// h (rows f-1, f, f+1 x frames t-1, t, t+1) in registers, used by three
// frames; it loads each column (three loads of 4 channels) two frames
// ahead of its use, so that the loads are in flight while the frame before
// computes; and it sums the taps F offset outer, T offset inner, as JAX
// `_stage_kernel` sums them. Zeros stand beyond the map's ends (the conv's
// zero padding), so any F and T work. A warp reads 128 contiguous channels
// of one row; the rows f-1 and f+1 are the rows of its neighbouring warps
// in the block (L1 hits). The t chunks split T until the launch has a few
// waves of threads.

constexpr int kDwCh = 4;                      // channels a thread
constexpr int kDwVec = 32;                    // threads a row
constexpr int kDwRowsPerBlock = 8;
constexpr int kDwThreads = kDwVec * kDwRowsPerBlock;
constexpr int kDwMinChunk = 16;               // frames a thread walks, least

__device__ __forceinline__ float4 load4(const float* p, bool valid) {
  return valid ? *reinterpret_cast<const float4*>(p) : float4{};
}
__device__ __forceinline__ void cvt4(const float4& v, float* out) {
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__global__ void __launch_bounds__(kDwThreads)
    depthwise3x3_kernel(const float* __restrict__ h,
                        const float* __restrict__ wdw,
                        const float* __restrict__ s2,
                        const float* __restrict__ t2, float* __restrict__ g,
                        int rows, int f, int t, int c4, int nc, int ntc,
                        int chunk) {
  unsigned idx = blockIdx.x;
  const int cc = idx % nc;
  idx /= nc;
  const int tc = idx % ntc;
  const int row = (int)(idx / ntc) * kDwRowsPerBlock + threadIdx.x / kDwVec;
  if (row >= rows) return;
  const int c = (cc * kDwVec + threadIdx.x % kDwVec) * kDwCh;
  const int fr = row % f;
  const bool valid_row[3] = {fr > 0, true, fr + 1 < f};
  const float* hr = h + (size_t)row * t * c4 + c;  // (row, frame 0)
  const long long row_step = (long long)t * c4;

  float w[9][kDwCh], sc[kDwCh], sh[kDwCh];
#pragma unroll
  for (int k = 0; k < 9; ++k) cvt4(load4(wdw + (size_t)k * c4 + c, true), w[k]);
  cvt4(load4(s2 + c, true), sc);
  cvt4(load4(t2 + c, true), sh);

  const int t0 = tc * chunk, t1 = min(t, t0 + chunk);
  float win[3][3][kDwCh];  // [row f-1, f, f+1][frame t-1, t, t+1]
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const int tq = t0 - 1 + dt;
      cvt4(load4(hr + (dr - 1) * row_step + (long long)tq * c4,
                 valid_row[dr] && tq >= 0 && tq < t),
           win[dr][dt]);
    }
  float4 ahead[3];  // frame t+1 as loaded
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
    ahead[dr] = load4(hr + (dr - 1) * row_step + (long long)(t0 + 1) * c4,
                      valid_row[dr] && t0 + 1 < t);
  for (int tq = t0; tq < t1; ++tq) {
    const bool later = tq + 2 < t;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const float4 v = load4(
          hr + (dr - 1) * row_step + (long long)(tq + 2) * c4,
          valid_row[dr] && later);
      cvt4(ahead[dr], win[dr][2]);
      ahead[dr] = v;
    }
    float acc[kDwCh];
#pragma unroll
    for (int e = 0; e < kDwCh; ++e) {
      acc[e] = 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
          acc[e] = fmaf(win[df][dt][e], w[df * 3 + dt][e], acc[e]);
      acc[e] = fmaxf(acc[e] * sc[e] + sh[e], 0.f);
    }
    *reinterpret_cast<float4*>(g + ((size_t)row * t + tq) * c4 + c) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int e = 0; e < kDwCh; ++e) {
        win[dr][0][e] = win[dr][1][e];
        win[dr][1][e] = win[dr][2][e];
      }
  }
}

cudaError_t depthwise3x3(const float* h, const float* wdw, const float* s2,
                         const float* t2, float* g, int b, int f, int t,
                         int c4, cudaStream_t stream) {
  constexpr int kChunk = kDwVec * kDwCh;  // channels a block
  if (c4 % kChunk) return cudaErrorInvalidValue;
  const int nc = c4 / kChunk;
  const long long rows = (long long)b * f;
  const long long row_groups = (rows + kDwRowsPerBlock - 1) / kDwRowsPerBlock;
  // t chunks: enough threads for ~4 waves of 2,048 a SM on 132 SMs, each
  // chunk at least kDwMinChunk frames
  const long long threads = rows * nc * kDwVec;
  long long ntc = (4LL * 132 * 2048 + threads - 1) / threads;
  ntc = std::max(1LL, std::min(ntc, (long long)(t + kDwMinChunk - 1) /
                                        kDwMinChunk));
  const int chunk = (int)((t + ntc - 1) / ntc);
  ntc = (t + chunk - 1) / chunk;
  const long long blocks = row_groups * ntc * nc;
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  depthwise3x3_kernel<<<(unsigned)blocks, kDwThreads, 0, stream>>>(
      h, wdw, s2, t2, g, (int)rows, f, t, c4, nc, (int)ntc, chunk);
  return cudaGetLastError();
}

cudaError_t inv_stage_f32(const float* x, const float* w1, const float* s1,
                          const float* t1, const float* wdw, const float* s2,
                          const float* t2, const float* w2, const float* s3,
                          const float* t3, float* h, float* g, float* out,
                          int b, int f, int t, int c, int blocks,
                          cudaStream_t stream) {
  const long long m = (long long)b * f * t;
  const int c4 = 4 * c;
  if (b < 1 || f < 1 || t < 1 || c % 32 || blocks < 1 || m > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err;
  for (int i = 0; i < blocks; ++i) {
    const float* xin = i == 0 ? x : out;
    // 1. h = relu((x @ w1[i]) * s1[i] + t1[i])
    GemmArgs p = gemm_args(xin, nullptr, nullptr, 1, c,
                           w1 + (size_t)i * c * c4, h, (int)m, c4, kNone);
    p.scale = s1 + (size_t)i * c4;
    p.shift = t1 + (size_t)i * c4;
    if ((err = gemm_affine_relu<float, kFormAffineRelu>(p, stream)) !=
        cudaSuccess)
      return err;
    // 2. g = relu(dw3x3(h) * s2[i] + t2[i])
    if ((err = depthwise3x3(h, wdw + (size_t)i * 9 * c4, s2 + (size_t)i * c4,
                            t2 + (size_t)i * c4, g, b, f, t, c4, stream)) !=
        cudaSuccess)
      return err;
    // 3. out = relu((g @ w2[i]) * s3[i] + t3[i] + x), in place from block 1
    GemmArgs q = gemm_args(g, nullptr, nullptr, 1, c4,
                           w2 + (size_t)i * c4 * c, out, (int)m, c, kNone);
    q.scale = s3 + (size_t)i * c;
    q.shift = t3 + (size_t)i * c;
    q.res = xin;
    if ((err = gemm_affine_relu<float, kFormAffineResRelu>(q, stream)) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

}  // namespace ws

extern "C" int ws_inv_stage_bf16(const void* x, const void* w1t,
                                 const void* w2t, const void* vecs,
                                 const float* s3, const float* t3, void* out,
                                 void* tmp, int b, int f, int t, int c,
                                 int blocks, int fo, int to, int fhalo,
                                 int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  const unsigned char* v = static_cast<const unsigned char*>(vecs);
  B* o = static_cast<B*>(out);
  B* tp = static_cast<B*>(tmp);
  if (b < 1 || f < 1 || t < 1 || blocks < 1) return cudaErrorInvalidValue;
  switch (c) {
    case 32:
      return ws::inv_stage_bf16<32>(x, w1t, w2t, v, s3, t3, o, tp, b, f, t,
                                    blocks, fo, to, fhalo, smem, s);
    case 64:
      return ws::inv_stage_bf16<64>(x, w1t, w2t, v, s3, t3, o, tp, b, f, t,
                                    blocks, fo, to, fhalo, smem, s);
    case 128:
      return ws::inv_stage_bf16<128>(x, w1t, w2t, v, s3, t3, o, tp, b, f, t,
                                     blocks, fo, to, fhalo, smem, s);
    case 256:
      return ws::inv_stage_bf16<256>(x, w1t, w2t, v, s3, t3, o, tp, b, f, t,
                                     blocks, fo, to, fhalo, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ws_inv_bottleneck_stage(
    const float* x, const float* w1, const float* s1, const float* t1,
    const float* wdw, const float* s2, const float* t2, const float* w2,
    const float* s3, const float* t3, float* h, float* g, float* out, int b,
    int f, int t, int c, int blocks, void* stream) {
  return ws::inv_stage_f32(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3, h, g, out,
                           b, f, t, c, blocks,
                           static_cast<cudaStream_t>(stream));
}
