// gemm_tn_sm90: the bf16 weight gradients of a backward on Hopper, up to
// three A^T B products of one launch over the same K rows:
//
//   out_q (m_q, n_q) = A_q^T B_q,  A_q (K, m_q), B_q (K, n_q) row-major bf16
//
// with f32 accumulation. Replaces common.cuh's WMMA gemm_tn in the training
// tail's bf16 backward (mfa_astp_train.cu: dwm = [x2 | x3 | x4]^T da, dk2 =
// att^T dlogits, dk1x = h^T dpre, K = B*T rows).
//
// Bound: operations; at B=256, T=200, C=512 the three are 281.8 GFLOP (dwm
// 241.6), 0.285 ms at 989 TFLOP/s, against 0.10 ms of bytes.
//
// Design. Both operands are row-major (K, .) matrices, so both tiles land
// MN-major: TMA loads boxes of 64 K rows x 64 columns (128-byte rows)
// under the 128-byte swizzle, which is wgmma's MN-major layout (an atom of
// 8 K rows x 64 columns; SBO = 8 rows, LBO = one box along M or N), and
// wgmma m64n128k16 reads them transposed (hopper.cuh's _tt form). A 128 x
// 128 output tile takes two A and two B boxes a 64-row K stage (32 KB);
// the ring, the producer warp and the two consumer warpgroups are
// gemm_sm90's. The products have few output tiles (dwm 144, dk2 and dk1x
// 12 each at C = 512), so K is split: a work unit is (split, tile), tiles
// fastest, so the units in flight share one K range in L2; the split count
// is the one with the least modelled time, the waves of units over the
// card's SMs times a unit's K tiles plus its epilogue
// (`gemm_tn_sm90_splits`). At B=256, T=200, C=512 that is 168 tiles x 7
// splits of 115 K tiles = 1,176 units, 8.9 waves of 132: 11 splits would
// fill 14 whole waves, but their 73-tile units pay the epilogue more often
// (cost 1,078 against 1,071). A persistent CTA an SM walks the units. Each unit stores its f32 partial tile
// from the registers into its split's slab of the workspace, and
// splitk_reduce_kernel sums the slabs in split order: the same bits every
// call, no atomics. Row tile m0 of a product whose A is three tensors side
// by side (dwm over x2, x3, x4) reads map m0 / a_cols at column m0 % a_cols
// (a select, not a dynamic index into the parameter).

#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

namespace ws {

constexpr int kTnBox = 64 * 64 * 2;     // 8 KB: 64 K rows x 64 columns
constexpr int kTnStage = 4 * kTnBox;    // two A and two B boxes
constexpr int kTnMaxA = 5, kTnMaxB = 3;
constexpr int kTnSmem = 1024 + kG9Stages * kTnStage + 2 * kG9Stages * 8;

struct TnMaps {
  CUtensorMap a[kTnMaxA];
  CUtensorMap b[kTnMaxB];
};

struct TnProblem {
  int m, n;     // the output, multiples of 128
  int a0;       // its first A map
  int a_cols;   // columns of each A map (m_q / a_cols maps side by side)
  int b;        // its B map
  int tile0;    // its first tile in the launch's walk
  long long off;  // its output's offset in a split's slab
};

struct TnArgs {
  TnProblem prob[3];
  int nprob, tiles, ktiles, kt_per, splits;
  long long slab;  // f32 elements a split: the sum of m_q n_q
  float* work;     // (splits, slab)
};

// the map at index i of n (a chain of selects)
template <int kN>
__device__ __forceinline__ const CUtensorMap* pick_map(
    const CUtensorMap (&maps)[kN], int i) {
  const CUtensorMap* m = &maps[0];
#pragma unroll
  for (int j = 1; j < kN; ++j) m = i == j ? &maps[j] : m;
  return m;
}

// A unit's product, output tile and K tiles.
struct TnUnit {
  TnProblem pr;
  int m0, n0, kt0, kt1;
};

__device__ __forceinline__ TnUnit tn_unit(const TnArgs& p, int u) {
  TnUnit w;
  const int tile = u % p.tiles, split = u / p.tiles;
  // the product by selects, so the parameter is never indexed dynamically
  w.pr = p.prob[0];
  if (p.nprob > 1 && tile >= p.prob[1].tile0) w.pr = p.prob[1];
  if (p.nprob > 2 && tile >= p.prob[2].tile0) w.pr = p.prob[2];
  const TnProblem& pr = w.pr;
  const int lt = tile - pr.tile0, ntn = pr.n / kG9N;
  w.m0 = (lt / ntn) * kG9M;
  w.n0 = (lt % ntn) * kG9N;
  w.kt0 = split * p.kt_per;
  w.kt1 = min(w.kt0 + p.kt_per, p.ktiles);
  return w;
}

__global__ void __launch_bounds__(kG9Threads, 1)
    gemm_tn_sm90_kernel(const __grid_constant__ TnMaps tm, const TnArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  const uint32_t bar_full = base + kG9Stages * kTnStage;
  const uint32_t bar_empty = bar_full + 8 * kG9Stages;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int units = p.tiles * p.splits;

  if (tid == 0) {
    for (int s = 0; s < kG9Stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // a lane of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (tid != 256) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const TnUnit w = tn_unit(p, u);
      const TnProblem& pr = w.pr;
      const int part = w.m0 / pr.a_cols;
      const CUtensorMap* ma = pick_map(tm.a, pr.a0 + part);
      const CUtensorMap* mb = pick_map(tm.b, pr.b);
      const int ca = w.m0 - part * pr.a_cols;
      for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
        const int s = it % kG9Stages;
        if (it >= kG9Stages)
          mbar_wait(bar_empty + 8 * s, ((it / kG9Stages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s, st = base + s * kTnStage;
        mbar_expect_tx(full, kTnStage);
        const int k = kt * 64;
        tma_load_2d(st, ma, ca, k, full);
        tma_load_2d(st + kTnBox, ma, ca + 64, k, full);
        tma_load_2d(st + 2 * kTnBox, mb, w.n0, k, full);
        tma_load_2d(st + 3 * kTnBox, mb, w.n0 + 64, k, full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63 ----
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
  float acc[64];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const TnUnit w = tn_unit(p, u);
    for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
      const int s = it % kG9Stages;
      mbar_wait(bar_full + 8 * s, (it / kG9Stages) & 1);
      const uint32_t st = base + s * kTnStage;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n128k16_tt(
            acc, wgmma_desc(st + wg * kTnBox + ks * 2048, kTnBox, 1024, 1),
            wgmma_desc(st + 2 * kTnBox + ks * 2048, kTnBox, 1024, 1),
            kt > w.kt0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired
      fence_regs(acc);
      if (kt > w.kt0)
        mbar_arrive_if(bar_empty + 8 * ((it - 1) % kG9Stages), lane == 0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(bar_empty + 8 * ((it - 1) % kG9Stages), lane == 0);

    // the f32 partial tile, straight from the registers: a warp's store
    // covers 8 rows of 32 contiguous bytes
    const TnProblem& pr = w.pr;
    float* out = p.work + (long long)(u / p.tiles) * p.slab + pr.off;
    const int r0 = w.m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = w.n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * h) * pr.n + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The split count of K (ktiles 64-row tiles) over `tiles` output tiles on
// `sms` SMs: the one of 1 .. 32 with the least modelled time, whole waves
// of units each of ceil(ktiles / s) K tiles plus about four tiles' worth
// for its epilogue; the smallest on a tie. Splits that would be empty are
// dropped (ceil(ktiles / kt_per) of them remain). Writes the K tiles a
// split to *kt_per. ops/gemm_sm90.py::tn_splits mirrors it.
inline int gemm_tn_sm90_splits(int tiles, int ktiles, int sms, int* kt_per) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= 32 && s <= ktiles; ++s) {
    const long long waves = ((long long)tiles * s + sms - 1) / sms;
    const long long cost = waves * ((ktiles + s - 1) / s + 4);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  const int per = (ktiles + best - 1) / best;
  if (kt_per) *kt_per = per;
  return (ktiles + per - 1) / per;
}

// One A^T B product of a launch: a_parts A tensors (each (k, a_cols)
// row-major, side by side: m = a_parts a_cols) and B (k, n) row-major, all
// bf16 and 16-byte aligned, its output (m, n) f32.
struct TnOperand {
  const void* a[3];
  int a_parts, a_cols;
  const void* b;
  int n;
  float* out;
};

// The workspace (f32 elements) a launch over these products needs.
inline size_t gemm_tn_sm90_workspace(const TnOperand* ops, int nops, int k) {
  int tiles = 0;
  size_t slab = 0;
  for (int i = 0; i < nops; ++i) {
    const int m = ops[i].a_parts * ops[i].a_cols;
    tiles += (m / kG9M) * (ops[i].n / kG9N);
    slab += (size_t)m * ops[i].n;
  }
  const int splits =
      gemm_tn_sm90_splits(tiles, (k + 63) / 64, sm_count(), nullptr);
  return (size_t)splits * slab;
}

// The products' outputs must be consecutive in one f32 buffer (out of
// product i + 1 = out of product i + m_i n_i): the fixed-order sum writes
// them in one pass. Requires every m and n a multiple of 128 (a_cols too
// where a_parts > 1), at most 5 A and 3 B tensors, and work of
// gemm_tn_sm90_workspace elements; else returns cudaErrorInvalidValue and
// launches nothing.
inline cudaError_t gemm_tn_sm90(const TnOperand* ops, int nops, int k,
                                float* work, size_t work_elems,
                                cudaStream_t stream) {
  if (nops < 1 || nops > 3 || k <= 0) return cudaErrorInvalidValue;
  TnMaps tm;
  TnArgs p{};
  int na = 0;
  long long off = 0;
  for (int i = 0; i < nops; ++i) {
    const TnOperand& o = ops[i];
    const int m = o.a_parts * o.a_cols;
    if (o.a_parts < 1 || o.a_parts > 3 || o.a_cols % 8 || m % kG9M ||
        (o.a_parts > 1 && o.a_cols % kG9M) || o.n % kG9N ||
        na + o.a_parts > kTnMaxA || o.out != ops[0].out + off)
      return cudaErrorInvalidValue;
    TnProblem& pr = p.prob[i];
    pr.m = m;
    pr.n = o.n;
    pr.a0 = na;
    pr.a_cols = o.a_parts > 1 ? o.a_cols : m;
    pr.b = i;
    pr.tile0 = p.tiles;
    pr.off = off;
    for (int j = 0; j < o.a_parts; ++j)
      if (!tensor_map_2d_bf16(&tm.a[na++], o.a[j], o.a_cols, k,
                              (unsigned long long)o.a_cols * 2, 64, 64, 128))
        return cudaErrorInvalidValue;
    if (!tensor_map_2d_bf16(&tm.b[i], o.b, o.n, k,
                            (unsigned long long)o.n * 2, 64, 64, 128))
      return cudaErrorInvalidValue;
    p.tiles += (m / kG9M) * (o.n / kG9N);
    off += (long long)m * o.n;
  }
  p.nprob = nops;
  p.slab = off;
  p.ktiles = (k + 63) / 64;
  p.splits = gemm_tn_sm90_splits(p.tiles, p.ktiles, sm_count(), &p.kt_per);
  p.work = work;
  if ((size_t)p.splits * p.slab > work_elems) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(gemm_tn_sm90_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTnSmem);
  if (err != cudaSuccess) return err;
  const int units = p.tiles * p.splits;
  const int grid = units < sm_count() ? units : sm_count();
  gemm_tn_sm90_kernel<<<grid, kG9Threads, kTnSmem, stream>>>(tm, p);
  ++gemm_route_counts()[kRouteTnSm90];
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  splitk_reduce_kernel<<<(unsigned)((p.slab + 255) / 256), 256, 0,
                         stream>>>(work, ops[0].out, p.splits,
                                   (size_t)p.slab);
  return cudaGetLastError();
}

}  // namespace ws
